"""Fused multi-head self-attention forward on packed QKV.

ref mpreid_tpu/ops/attention.py::fused_attention, ::fused_attention_hm,
::mha_reference, ::mha_reference_hm, ::head_major_perm,
::head_major_perm_inverse.

``fused_attention`` takes the QKV activation ``(B, L, 3D)`` straight out of
the in_proj matmul and returns ``(B, L, D)`` ready for out_proj. Two column
layouts, one kernel:

* ``"packed"``: torch ``nn.MultiheadAttention`` packing [q|k|v]; head h
  reads q at column ``h·dh``, k at ``D + h·dh``, v at ``2D + h·dh``. The
  port stores its parameters in this layout, so it is the main path's form.
* ``"head_major"``: per-head [q_h|k_h|v_h] at column ``h·3dh``, the layout
  the JAX package's ``hm``/``hm_native`` towers emit.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
(``kernels/csrc/attention_fwd.cu``) or raises; on a CPU tensor it computes
``attention_plain``, the same function in plain PyTorch. Numerics, as in
the JAX package: q is scaled in the activation dtype, logits and softmax are
fp32, probabilities are rounded to the activation dtype before P·V, which
sums in fp32. ``mask`` is an additive (L, L) mask, constant by contract
(the causal text mask holds -inf above the diagonal). Forward only: the
backward kernel belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

LAYOUTS = ("packed", "head_major")
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def head_major_perm(d: int, num_heads: int) -> np.ndarray:
    """Column permutation: torch packing [q|k|v] → per-head [q_h|k_h|v_h]."""
    dh = d // num_heads
    idx = []
    for h in range(num_heads):
        for part in range(3):
            start = part * d + h * dh
            idx.extend(range(start, start + dh))
    perm = np.asarray(idx, np.int32)
    perm.setflags(write=False)  # cached: shared by every caller
    return perm


@functools.lru_cache(maxsize=None)
def head_major_perm_inverse(d: int, num_heads: int) -> np.ndarray:
    """Inverse column permutation: per-head [q_h|k_h|v_h] → torch [q|k|v]."""
    inv = np.argsort(head_major_perm(d, num_heads)).astype(np.int32)
    inv.setflags(write=False)  # cached: shared by every caller
    return inv


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown attention layout {layout!r}; expected one of {LAYOUTS}")


def _column_offsets(d: int, dh: int, layout: str):
    """(q_base, k_base, v_base, head_stride) of head 0 and the step per head."""
    if layout == "packed":
        return 0, d, 2 * d, dh
    return 0, dh, 2 * dh, 3 * dh


def attention_plain(qkv: torch.Tensor, num_heads: int,
                    mask: Optional[torch.Tensor] = None,
                    layout: str = "packed") -> torch.Tensor:
    """The kernel's function in plain PyTorch (CPU path and the kernel's check)."""
    _check_layout(layout)
    b, l, dd = qkv.shape
    d = dd // 3
    dh = d // num_heads
    dtype = qkv.dtype
    if layout == "packed":
        q, k, v = (t.reshape(b, l, num_heads, dh) for t in qkv.split(d, dim=-1))
    else:
        t = qkv.reshape(b, l, num_heads, 3 * dh)
        q, k, v = t[..., :dh], t[..., dh:2 * dh], t[..., 2 * dh:]
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # (B, H, L, dh)
    scale = torch.tensor(dh ** -0.5, dtype=dtype)
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.to(device=logits.device, dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    out = torch.matmul(probs.float(), v.float()).to(dtype)
    return out.transpose(1, 2).reshape(b, l, d)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library (built at first use) with its C signatures declared."""
    from mpreid_tpu_torch.kernels import build

    lib = build.load("attention_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mpreid_mha_fwd.argtypes = [p, p, p, i, i, i, i, i, ll, i, i, i, i,
                                   ctypes.c_float, p]
    lib.mpreid_mha_fwd.restype = i
    lib.mpreid_mha_fwd_smem_bytes.argtypes = [i, i, i]
    lib.mpreid_mha_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.mpreid_mha_fwd_max_smem_bytes.argtypes = []
    lib.mpreid_mha_fwd_max_smem_bytes.restype = ctypes.c_size_t
    return lib


def _launch_cuda(qkv, num_heads, mask, layout):
    if qkv.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"fused_attention takes {SUPPORTED_DTYPES}, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("fused_attention needs a contiguous qkv")
    if qkv.data_ptr() % 16:
        raise ValueError("fused_attention needs a 16-byte aligned qkv")
    cap = torch.cuda.get_device_capability(qkv.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the attention kernel is built for sm_90a; device capability is {cap}"
        )
    b, l, dd = qkv.shape
    d = dd // 3
    dh = d // num_heads
    if dh not in (64, 128):
        raise ValueError(f"the attention kernel takes head widths 64 and 128, got {dh}")
    if mask is not None:
        if tuple(mask.shape) != (l, l):
            raise ValueError(f"mask must be ({l}, {l}), got {tuple(mask.shape)}")
        mask = mask.to(device=qkv.device, dtype=torch.float32).contiguous()
    lib = _library()
    is_bf16 = int(qkv.dtype == torch.bfloat16)
    smem = lib.mpreid_mha_fwd_smem_bytes(is_bf16, l, dh)
    if smem > lib.mpreid_mha_fwd_max_smem_bytes():
        raise ValueError(
            f"sequence length {l} needs {smem} bytes of shared memory per block, "
            f"more than the {lib.mpreid_mha_fwd_max_smem_bytes()} a block may use"
        )
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or l == 0:
        return out
    q_base, k_base, v_base, head_stride = _column_offsets(d, dh, layout)
    rc = lib.mpreid_mha_fwd(
        qkv.data_ptr(), mask.data_ptr() if mask is not None else None,
        out.data_ptr(), is_bf16, b, l, num_heads, dh, dd,
        q_base, k_base, v_base, head_stride, dh ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {rc}")
    fused_attention.launches += 1
    return out


def fused_attention(qkv: torch.Tensor, num_heads: int,
                    mask: Optional[torch.Tensor] = None,
                    layout: str = "packed") -> torch.Tensor:
    """Multi-head self-attention on packed ``(B, L, 3D)`` QKV → ``(B, L, D)``.

    CUDA tensors run the Hopper kernel (no synchronisation, launched on the
    current stream) and count one launch in ``fused_attention.launches``;
    CPU tensors run ``attention_plain``.
    """
    _check_layout(layout)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(
            f"qkv must be (B, L, 3·D) with D divisible by {num_heads} heads, "
            f"got {tuple(qkv.shape)}"
        )
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads, mask, layout)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"fused_attention runs on cuda or cpu, not {qkv.device}")
    return _launch_cuda(qkv, num_heads, mask, layout)


fused_attention.launches = 0
