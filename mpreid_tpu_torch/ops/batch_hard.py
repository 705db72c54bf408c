"""Fused pairwise distance and batch-hard mining, and its triplet loss.

ref mpreid_tpu/ops/pallas_kernels.py::_batch_hard_forward,
::_batch_hard_xla, ::fused_batch_hard, ::_fbh_bwd,
::batch_hard_triplet_loss.

For B feature rows and their labels, per anchor i: ``dist_ap`` the largest
euclidean distance to a same-label row (``p_idx`` its index), ``dist_an``
the smallest to another-label row (``n_idx``), each index the first one of
a tie, as ``jnp.argmax``/``argmin`` give it; a row with no negative gets
``dist_an = +inf`` and ``n_idx = 0``. Features are read as fp32 whatever
their dtype; indices are int32, as the JAX package returns them.

On a CUDA tensor the forward launches the hand-written Hopper kernel
(``kernels/csrc/batch_hard.cu``: clusters of 8 blocks, 8 anchor rows a
cluster up to B 64 and 16 above, an eighth of D a block, the partial dot products summed through
distributed shared memory; no distance reaches device memory) or raises; on a CPU tensor it computes ``batch_hard_plain``, the same
function in plain PyTorch (``euclidean_dist`` plus masked max/min/argmax/
argmin). ``fused_batch_hard`` counts its kernel launches in ``.launches``.
The gradient is the JAX package's custom VJP, written in torch ops (a
gather and an ``index_add_`` through the chosen pairs), not a kernel.

The JAX functions' ``use_pallas`` argument is left out: on the card the
port always launches the kernel. As in the JAX package, no config switch
reaches these functions; the training path's triplet loss is
``losses/triplet.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from mpreid_tpu_torch.losses.triplet import euclidean_dist

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def batch_hard_plain(feats: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (dist_ap, dist_an, p_idx, n_idx) in plain PyTorch (ref ``_batch_hard_xla``)."""
    f = feats.float()
    d = euclidean_dist(f, f)
    is_pos = labels[:, None] == labels[None, :]
    masked_pos = torch.where(is_pos, d, float("-inf"))
    masked_neg = torch.where(is_pos, float("inf"), d)
    # torch.max/min over a dim return the first index of a tie, as jnp.argmax does
    ap, p = masked_pos.max(dim=1)
    an, n = masked_neg.min(dim=1)
    return ap, an, p.int(), n.int()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from mpreid_tpu_torch.kernels import build

    lib = build.load("batch_hard")
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p, p, p, p, p, p, i, i, ctypes.c_longlong, i]
    lib.mpreid_batch_hard.argtypes = lib.mpreid_batch_hard_floor.argtypes = head + [p]
    lib.mpreid_batch_hard_tiled.argtypes = head + [i, i, i, p]
    for fn in (lib.mpreid_batch_hard, lib.mpreid_batch_hard_floor, lib.mpreid_batch_hard_tiled):
        fn.restype = i
    lib.mpreid_batch_hard_smem_bytes.argtypes = [i, i]
    lib.mpreid_batch_hard_smem_bytes.restype = ctypes.c_longlong
    return lib


def shared_bytes(b: int, d: int) -> int:
    """Bytes of dynamic shared memory a block of the kernel takes at (B, D)."""
    return _library().mpreid_batch_hard_smem_bytes(b, d)


def _launch_cuda(feats: torch.Tensor, labels: torch.Tensor, floor: bool = False,
                 shape: int = -1):
    if feats.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"fused_batch_hard takes {SUPPORTED_DTYPES} on the card, got {feats.dtype}")
    if feats.shape[1] > 1 and feats.stride(1) != 1:
        raise ValueError("fused_batch_hard needs contiguous rows (stride 1 along D)")
    cap = torch.cuda.get_device_capability(feats.device)
    if cap != (9, 0):
        raise RuntimeError(f"the batch-hard kernel is built for sm_90a; device capability is {cap}")
    b, d = feats.shape
    lab = labels.to(device=feats.device, dtype=torch.int32).contiguous()
    ap = torch.empty(b, dtype=torch.float32, device=feats.device)
    an = torch.empty_like(ap)
    p = torch.empty(b, dtype=torch.int32, device=feats.device)
    n = torch.empty_like(p)
    if b == 0:
        return ap, an, p, n
    ld = feats.stride(0) if b > 1 else d
    lib = _library()
    args = (feats.data_ptr(), lab.data_ptr(), ap.data_ptr(), an.data_ptr(), p.data_ptr(),
            n.data_ptr(), b, d, ld, int(feats.dtype == torch.bfloat16))
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    if floor:
        rc = lib.mpreid_batch_hard_floor(*args, stream)
    elif shape >= 0:
        rc = lib.mpreid_batch_hard_tiled(*args, 1 << 30, 1 << 30, shape, stream)
    else:
        rc = lib.mpreid_batch_hard(*args, stream)
    if rc != 0:
        raise RuntimeError(f"batch-hard kernel launch failed with CUDA error {rc}")
    if not floor and shape < 0:
        fused_batch_hard.launches += 1
    return ap, an, p, n


def launch_floor(feats: torch.Tensor, labels: torch.Tensor) -> None:
    """An empty kernel launched as ``batch_hard_mining`` launches the kernel
    on a CUDA tensor (the wrapper's checks and outputs, the kernel's grid,
    cluster, block and arguments), counted nowhere: the floor of a
    launch-bound call, timed beside the kernel. Its outputs are left unset."""
    _launch_cuda(feats, labels, floor=True)


def launch_at_shape(feats: torch.Tensor, labels: torch.Tensor, shape: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on a CUDA tensor at its shape ``shape`` whatever B (0: 8
    anchor rows a cluster, 1: 16; ``batch_hard_mining`` takes 0 up to B 64),
    counted nowhere: chip_smoke.py times both at each timed batch."""
    return _launch_cuda(feats, labels, shape=shape)


def batch_hard_mining(feats: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (dist_ap, dist_an, p_idx, n_idx) without a gradient: the kernel for
    a CUDA tensor, ``batch_hard_plain`` for a CPU tensor."""
    if feats.dim() != 2 or labels.shape != feats.shape[:1]:
        raise ValueError(f"fused_batch_hard takes (B, D) features and (B,) labels, got "
                         f"{tuple(feats.shape)} and {tuple(labels.shape)}")
    with torch.no_grad():
        if feats.device.type == "cpu":
            return batch_hard_plain(feats, labels)
        if feats.device.type != "cuda":
            raise RuntimeError(f"fused_batch_hard runs on cuda or cpu, not {feats.device}")
        return _launch_cuda(feats, labels)


def _pair_grad(f: torch.Tensor, g: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor):
    """d = ‖f_i − f_j‖: ∂d/∂f_i = (f_i − f_j)/d, ∂d/∂f_j = −(f_i − f_j)/d."""
    idx = idx.long()
    u = (g / torch.clamp(dist, min=1e-12))[:, None] * (f - f[idx])
    return u + torch.zeros_like(f).index_add_(0, idx, -u)


class FusedBatchHard(torch.autograd.Function):
    """(dist_ap, dist_an) with the JAX package's VJP (ref ``_fbh_bwd``): the
    gradient goes through the chosen pairs only."""

    @staticmethod
    def forward(ctx, feats, labels):
        ap, an, p, n = batch_hard_mining(feats, labels)
        ctx.save_for_backward(feats, ap, an, p, n)
        ctx.mark_non_differentiable(p, n)
        return ap, an, p, n

    @staticmethod
    def backward(ctx, g_ap, g_an, _gp, _gn):
        feats, ap, an, p, n = ctx.saved_tensors
        f = feats.float()
        df = _pair_grad(f, g_ap, p, ap) + _pair_grad(f, g_an, n, an)
        return df.to(feats.dtype), None


def fused_batch_hard(feats: torch.Tensor, labels: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (dist_ap, dist_an): the hardest positive and negative distance per
    anchor, differentiable in ``feats``. CUDA tensors run the Hopper kernel
    (no synchronisation, launched on the current stream) and count one launch
    in ``fused_batch_hard.launches``; CPU tensors run ``batch_hard_plain``."""
    ap, an, _, _ = FusedBatchHard.apply(feats, labels)
    return ap, an


fused_batch_hard.launches = 0


def batch_hard_triplet_loss(feats: torch.Tensor, labels: torch.Tensor,
                            margin: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (loss, dist_ap, dist_an): the triplet loss over ``fused_batch_hard``
    (a drop-in for ``losses.triplet_loss``): the margin ranking loss with
    ``margin``, the soft margin ``softplus(ap − an)`` without (the hinge and
    softplus in ``losses/triplet.py``'s forms)."""
    ap, an = fused_batch_hard(feats, labels)
    x = ap - an
    zero = torch.zeros_like(x)
    if margin is not None:
        loss = torch.mean(torch.maximum(x + margin, zero))
    else:
        loss = torch.mean(torch.logaddexp(x, zero))
    return loss, ap, an
