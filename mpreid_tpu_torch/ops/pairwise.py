"""Pairwise L1 and min-sum cross "distances" between two sets of rows.

ref mpreid_tpu/ops/pallas_kernels.py::l1_cross_pallas, ::l1_cross,
::minsum_cross_pallas, ::minsum_cross, ::_minsum_cross_xla, and
mpreid_tpu/ops/reranking.py::_l1_cross.

For ``vq`` (Q, N) and ``vg`` (G, N) in fp32:

* ``l1_cross``     → (Q, G) Σₖ |vqᵢₖ − vgⱼₖ|  (dense re-ranking's exact
  Jaccard step, min-sum = 1 − L1/2 for rows that sum to 1);
* ``minsum_cross`` → (Q, G) Σₖ min(vqᵢₖ, vgⱼₖ)  (sparse-V re-ranking's
  exact min-sum, whose truncated rows need not sum to 1).

On CUDA tensors the wrappers launch the hand-written Hopper kernels
(``kernels/csrc/pairwise_cross.cu``: one 64 × 64 output tile per block, a
loop over K inside it, ragged edges masked, no padded copies) or raise; on
CPU tensors they compute ``l1_cross_plain`` / ``minsum_cross_plain``, the
same functions in plain PyTorch, chunked over query rows and K so the
broadcast temporary stays bounded (the JAX package's ``(128, G, N)``
broadcast is fused away by XLA; in eager PyTorch it would be materialised).
Each wrapper counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# elements of one broadcast temporary of the plain versions
_PLAIN_BUDGET = 1 << 25
_PLAIN_K_CHUNK = 1024
_TILE = 64  # output rows per block of the kernel (grid.y ≤ 65535)


def _cross_plain(vq: torch.Tensor, vg: torch.Tensor, op) -> torch.Tensor:
    q, n = vq.shape
    g = vg.shape[0]
    out = torch.zeros((q, g), dtype=torch.float32, device=vq.device)
    kc = max(1, min(_PLAIN_K_CHUNK, n))
    rows = max(1, _PLAIN_BUDGET // max(1, g * kc))
    for lo in range(0, q, rows):
        acc = out[lo:lo + rows]
        a = vq[lo:lo + rows, None, :]
        for k0 in range(0, n, kc):
            acc += op(a[..., k0:k0 + kc], vg[None, :, k0:k0 + kc]).sum(-1)
    return out


def l1_cross_plain(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """(Q, G) Σₖ |vqᵢₖ − vgⱼₖ| in plain PyTorch (fp32)."""
    return _cross_plain(vq, vg, lambda a, b: (a - b).abs())


def minsum_cross_plain(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """(Q, G) Σₖ min(vqᵢₖ, vgⱼₖ) in plain PyTorch (fp32)."""
    return _cross_plain(vq, vg, torch.minimum)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from mpreid_tpu_torch.kernels import build

    lib = build.load("pairwise_cross")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.mpreid_l1_cross, lib.mpreid_minsum_cross):
        fn.argtypes = [p, p, p, i, i, i, ll, ll, ll, p]
        fn.restype = i
    return lib


def _check(vq: torch.Tensor, vg: torch.Tensor, what: str) -> None:
    if vq.dim() != 2 or vg.dim() != 2:
        raise ValueError(f"{what} takes 2-D (Q, N) and (G, N), got {tuple(vq.shape)} "
                         f"and {tuple(vg.shape)}")
    if vq.shape[1] != vg.shape[1]:
        raise ValueError(f"{what} needs one N, got {vq.shape[1]} and {vg.shape[1]}")
    if vq.dtype != torch.float32 or vg.dtype != torch.float32:
        raise TypeError(f"{what} takes fp32, got {vq.dtype} and {vg.dtype}")
    if vq.device != vg.device:
        raise ValueError(f"{what} needs both on one device, got {vq.device} and {vg.device}")
    if vq.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} runs on cuda or cpu, not {vq.device}")


def _row_stride(t: torch.Tensor, what: str) -> int:
    """The row stride of a matrix whose rows are contiguous."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{what} needs contiguous rows (stride 1 along N)")
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _launch_cuda(name: str, vq: torch.Tensor, vg: torch.Tensor, wrapper) -> torch.Tensor:
    cap = torch.cuda.get_device_capability(vq.device)
    if cap != (9, 0):
        raise RuntimeError(f"the {name} kernel is built for sm_90a; device capability is {cap}")
    q, n = vq.shape
    g = vg.shape[0]
    if -(-q // _TILE) > 65535:
        raise ValueError(f"{name} takes at most {65535 * _TILE} query rows, got {q}")
    lda, ldb = _row_stride(vq, name), _row_stride(vg, name)
    out = torch.empty((q, g), dtype=torch.float32, device=vq.device)
    if q == 0 or g == 0:
        return out
    rc = getattr(_library(), f"mpreid_{name}")(
        vq.data_ptr(), vg.data_ptr(), out.data_ptr(), q, g, n, lda, ldb, g,
        torch.cuda.current_stream(vq.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    wrapper.launches += 1
    return out


def l1_cross(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """(Q, G) Σₖ |vqᵢₖ − vgⱼₖ| of fp32 (Q, N) and (G, N) rows.

    CUDA tensors run the Hopper kernel (no synchronisation, launched on the
    current stream) and count one launch in ``l1_cross.launches``; CPU
    tensors run ``l1_cross_plain``."""
    _check(vq, vg, "l1_cross")
    if vq.device.type == "cpu":
        return l1_cross_plain(vq, vg)
    return _launch_cuda("l1_cross", vq, vg, l1_cross)


def minsum_cross(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """(Q, G) Σₖ min(vqᵢₖ, vgⱼₖ) of fp32 (Q, N) and (G, N) rows.

    CUDA tensors run the Hopper kernel and count one launch in
    ``minsum_cross.launches``; CPU tensors run ``minsum_cross_plain``."""
    _check(vq, vg, "minsum_cross")
    if vq.device.type == "cpu":
        return minsum_cross_plain(vq, vg)
    return _launch_cuda("minsum_cross", vq, vg, minsum_cross)


l1_cross.launches = 0
minsum_cross.launches = 0
