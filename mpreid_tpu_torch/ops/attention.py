"""Fused multi-head self-attention on packed QKV, forward and backward.

ref mpreid_tpu/ops/attention.py::fused_attention, ::fused_attention_hm,
::mha_reference, ::mha_reference_hm, ::head_major_perm,
::head_major_perm_inverse, ::_mha_bwd_kernel, ::_mha_bwd_kernel_hm,
::_fused_mha_bwd.

``fused_attention`` takes the QKV activation ``(B, L, 3D)`` straight out of
the in_proj matmul and returns ``(B, L, D)`` ready for out_proj. Two column
layouts, one kernel:

* ``"packed"``: torch ``nn.MultiheadAttention`` packing [q|k|v]; head h
  reads q at column ``h·dh``, k at ``D + h·dh``, v at ``2D + h·dh``. The
  port stores its parameters in this layout, so it is the main path's form.
* ``"head_major"``: per-head [q_h|k_h|v_h] at column ``h·3dh``, the layout
  the JAX package's ``hm``/``hm_native`` towers emit.

On a CUDA tensor the wrappers launch a hand-written Hopper kernel or
raise; ``attention_route`` picks it before the launch from the dtype alone:
bf16 goes to the bf16 tensor-core kernels (route ``"tc"``,
``kernels/csrc/attention_{fwd,bwd}_tc.cu``), fp32 to the kernels that take
each fp32 product on the tensor cores in three TF32 passes (route
``"tf32x3"``, ``kernels/csrc/attention_{fwd,bwd}.cu``), which hold fp32 to
1e-5 where one TF32 pass could not; they stream their tiles, so they take
any length. On a CPU tensor they
compute ``attention_plain`` and ``attention_bwd_plain``, the same functions
in plain PyTorch. Numerics, as in the JAX package: q is scaled in the
activation dtype, logits and softmax are fp32, probabilities are rounded to
the activation dtype before P·V, which sums in fp32. ``mask`` is an
additive (L, L) mask, constant by contract (the causal text mask holds -inf
above the diagonal) and given no gradient.

When ``qkv`` requires a gradient, ``fused_attention`` goes through
``FusedAttention``, a ``torch.autograd.Function`` that saves only ``qkv``
(and the mask): the backward recomputes the probabilities from them, as the
JAX package's VJP does, and saves none.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

LAYOUTS = ("packed", "head_major")
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
HEAD_WIDTHS = (64, 128)
ROUTES = ("tc", "tf32x3")


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


def _split_heads(qkv: torch.Tensor, num_heads: int, layout: str):
    """(q, k, v), each (B, H, L, dh), viewed out of ``qkv`` in ``layout``."""
    b, l, dd = qkv.shape
    d = dd // 3
    dh = d // num_heads
    if layout == "packed":
        q, k, v = (t.reshape(b, l, num_heads, dh) for t in qkv.split(d, dim=-1))
    else:
        t = qkv.reshape(b, l, num_heads, 3 * dh)
        q, k, v = t[..., :dh], t[..., dh:2 * dh], t[..., 2 * dh:]
    return tuple(t.transpose(1, 2) for t in (q, k, v))


def _probs(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """fp32 softmax((q·scale)·kᵀ + mask), q scaled in the activation dtype."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=q.dtype)
    logits = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask.to(device=logits.device, dtype=torch.float32)
    return torch.softmax(logits, dim=-1)


def attention_plain(qkv: torch.Tensor, num_heads: int,
                    mask: Optional[torch.Tensor] = None,
                    layout: str = "packed") -> torch.Tensor:
    """The kernel's function in plain PyTorch (CPU path and the kernel's check)."""
    _check_layout(layout)
    b, l, dd = qkv.shape
    dtype = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads, layout)  # (B, H, L, dh)
    probs = _probs(q, k, mask).to(dtype)
    out = torch.matmul(probs.float(), v.float()).to(dtype)
    return out.transpose(1, 2).reshape(b, l, dd // 3)


def attention_bwd_plain(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                        mask: Optional[torch.Tensor] = None,
                        layout: str = "packed") -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: ``dqkv`` from ``qkv``
    and the output's cotangent ``do`` (B, L, D), in ``qkv``'s packing.

    The JAX backward's math written out (not autograd of ``attention_plain``):
    p recomputed in fp32; ``pc = p`` rounded to the activation dtype;
    dv = pcᵀ·do and dp = do·vᵀ summed in fp32; ds = p ⊙ (dp − rowsum(dp ⊙ p))
    with the fp32 p; dq = ds·k·scale and dk = dsᵀ·q·scale with ds rounded
    to the activation dtype, unscaled q and k, and the scale applied in fp32.
    """
    _check_layout(layout)
    b, l, dd = qkv.shape
    d = dd // 3
    dh = d // num_heads
    dtype = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads, layout)
    dout = do.reshape(b, l, num_heads, dh).transpose(1, 2).float()
    p = _probs(q, k, mask)
    pc = p.to(dtype).float()
    dv = torch.matmul(pc.transpose(-1, -2), dout)
    dp = torch.matmul(dout, v.float().transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dsc = ds.to(dtype).float()
    scale = dh ** -0.5
    dq = torch.matmul(dsc, k.float()) * scale
    dk = torch.matmul(dsc.transpose(-1, -2), q.float()) * scale
    parts = [t.to(dtype).transpose(1, 2) for t in (dq, dk, dv)]  # (B, L, H, dh)
    if layout == "packed":
        return torch.cat([t.reshape(b, l, d) for t in parts], dim=-1)
    return torch.cat(parts, dim=-1).reshape(b, l, dd)


def attention_route(dtype: torch.dtype, dh: int) -> str:
    """The kernel family a CUDA tensor of ``dtype`` at head width ``dh``
    launches: ``"tc"`` (bf16 on the tensor cores) or ``"tf32x3"`` (fp32 on
    the tensor cores, three TF32 passes a product). Raises for what neither
    takes."""
    if dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"the attention kernels take {SUPPORTED_DTYPES}, got {dtype}")
    if dh not in HEAD_WIDTHS:
        raise ValueError(f"the attention kernels take head widths {HEAD_WIDTHS}, got {dh}")
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


@functools.lru_cache(maxsize=None)
def _library(direction: str, route: str) -> ctypes.CDLL:
    """The library of ``csrc/attention_<direction>[_tc].cu`` (``fwd`` or
    ``bwd``; ``_tc`` on the ``"tc"`` route), built at first use, with its C
    signatures declared on ``lib.launch``, ``lib.smem_bytes`` and
    ``lib.max_smem_bytes``; the fp32 backward adds ``lib.scratch_floats``."""
    from mpreid_tpu_torch.kernels import build

    suffix = "_tc" if route == "tc" else ""
    lib = build.load(f"attention_{direction}{suffix}")
    symbol = f"mpreid_mha_{direction}{suffix}"
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # qkv, mask, out; the backward adds dout, and the fp32 backward a scratch
    # array for its row statistics
    scratch = direction == "bwd" and route == "tf32x3"
    tensors = [p] * ({"fwd": 3, "bwd": 4}[direction] + scratch)
    lib.launch = getattr(lib, symbol)
    lib.launch.argtypes = tensors + [i, i, i, i, ll, i, i, i, i, ctypes.c_float, p]
    lib.launch.restype = i
    lib.smem_bytes = getattr(lib, f"{symbol}_smem_bytes")
    lib.smem_bytes.argtypes, lib.smem_bytes.restype = [i, i], ctypes.c_size_t
    lib.max_smem_bytes = getattr(lib, f"{symbol}_max_smem_bytes")
    lib.max_smem_bytes.argtypes, lib.max_smem_bytes.restype = [], ctypes.c_size_t
    if scratch:
        lib.scratch_floats = getattr(lib, f"{symbol}_scratch_floats")
        lib.scratch_floats.argtypes, lib.scratch_floats.restype = [i, i, i], ll
    return lib


def _check_cuda(direction: str, qkv: torch.Tensor, num_heads: int, mask):
    """Refuse what the ``direction`` kernel does not take → (lib, route, dh,
    mask as a contiguous fp32 (L, L) on the card or None)."""
    what = "fused_attention" if direction == "fwd" else "fused_attention_bwd"
    _, l, dd = qkv.shape
    dh = dd // 3 // num_heads
    route = attention_route(qkv.dtype, dh)
    if not qkv.is_contiguous():
        raise ValueError(f"{what} needs a contiguous qkv")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{what} needs a 16-byte aligned qkv")
    cap = torch.cuda.get_device_capability(qkv.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the attention kernels are built for sm_90a; device capability is {cap}"
        )
    if mask is not None:
        if tuple(mask.shape) != (l, l):
            raise ValueError(f"mask must be ({l}, {l}), got {tuple(mask.shape)}")
        mask = mask.to(device=qkv.device, dtype=torch.float32).contiguous()
    lib = _library(direction, route)
    smem, limit = lib.smem_bytes(l, dh), lib.max_smem_bytes()
    if smem > limit:
        longest = max(n for n in range(1, l) if lib.smem_bytes(n, dh) <= limit)
        raise ValueError(
            f"{what}: sequence length {l} at head width {dh} in {qkv.dtype} needs "
            f"{smem} bytes of shared memory per block, more than the {limit} a block may "
            f"use: L above {longest} needs more shared memory than a block has"
        )
    return lib, route, dh, mask


def _launch_cuda(qkv, num_heads, mask, layout):
    lib, route, dh, mask = _check_cuda("fwd", qkv, num_heads, mask)
    b, l, dd = qkv.shape
    d = dd // 3
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    if b == 0 or l == 0:
        return out
    q_base, k_base, v_base, head_stride = _column_offsets(d, dh, layout)
    rc = lib.launch(
        qkv.data_ptr(), mask.data_ptr() if mask is not None else None,
        out.data_ptr(), b, l, num_heads, dh, dd,
        q_base, k_base, v_base, head_stride, dh ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"attention kernel launch failed with CUDA error {rc}")
    fused_attention.launches += 1
    fused_attention.launches_by_route[route] += 1
    return out


def _launch_bwd_cuda(qkv, do, num_heads, mask, layout):
    lib, route, dh, mask = _check_cuda("bwd", qkv, num_heads, mask)
    b, l, dd = qkv.shape
    d = dd // 3
    if do.dtype != qkv.dtype or tuple(do.shape) != (b, l, d):
        raise ValueError(
            f"do must be {qkv.dtype} ({b}, {l}, {d}), got {do.dtype} {tuple(do.shape)}"
        )
    if not do.is_contiguous() or do.data_ptr() % 16 or do.device != qkv.device:
        raise ValueError("fused_attention_bwd needs a contiguous, 16-byte aligned do "
                         "on qkv's device")
    dqkv = torch.empty_like(qkv)
    if b == 0 or l == 0:
        return dqkv
    q_base, k_base, v_base, head_stride = _column_offsets(d, dh, layout)
    scratch = []
    if route == "tf32x3":  # m, 1/l and delta of every row, from one launch to the next
        scratch = [torch.empty(lib.scratch_floats(b, l, num_heads), dtype=torch.float32,
                               device=qkv.device).data_ptr()]
    rc = lib.launch(
        qkv.data_ptr(), mask.data_ptr() if mask is not None else None,
        do.data_ptr(), dqkv.data_ptr(), *scratch, b, l, num_heads, dh, dd,
        q_base, k_base, v_base, head_stride, dh ** -0.5,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"attention backward kernel launch failed with CUDA error {rc}")
    fused_attention_bwd.launches += 1
    fused_attention_bwd.launches_by_route[route] += 1
    return dqkv


def _check_args(qkv: torch.Tensor, num_heads: int, layout: str) -> None:
    _check_layout(layout)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(
            f"qkv must be (B, L, 3·D) with D divisible by {num_heads} heads, "
            f"got {tuple(qkv.shape)}"
        )
    if qkv.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"the attention kernels run on cuda or cpu, not {qkv.device}")


def _forward(qkv, num_heads, mask, layout):
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads, mask, layout)
    return _launch_cuda(qkv, num_heads, mask, layout)


def fused_attention_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                        mask: Optional[torch.Tensor] = None,
                        layout: str = "packed") -> torch.Tensor:
    """``dqkv`` (B, L, 3D) from ``qkv`` and the output's cotangent ``do``.

    CUDA tensors run the Hopper backward kernel of ``attention_route`` (no
    synchronisation, launched on the current stream) and count one launch in
    ``fused_attention_bwd.launches`` and in its route's entry of
    ``fused_attention_bwd.launches_by_route``; CPU tensors run
    ``attention_bwd_plain``.
    """
    _check_args(qkv, num_heads, layout)
    if qkv.device.type == "cpu":
        return attention_bwd_plain(qkv, do, num_heads, mask, layout)
    return _launch_bwd_cuda(qkv, do, num_heads, mask, layout)


fused_attention_bwd.launches = 0
fused_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


class FusedAttention(torch.autograd.Function):
    """The forward and backward kernels joined as one differentiable op.

    Saves only ``qkv`` and the mask (ref ``_fused_mha_fwd``); the mask gets
    no gradient (ref ``_fused_mha_bwd``)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, mask, layout):
        ctx.num_heads, ctx.layout, ctx.masked = num_heads, layout, mask is not None
        ctx.save_for_backward(qkv, *([mask] if mask is not None else []))
        return _forward(qkv, num_heads, mask, layout)

    @staticmethod
    def backward(ctx, do):
        qkv, *mask = ctx.saved_tensors
        dqkv = fused_attention_bwd(qkv, do.contiguous(), ctx.num_heads,
                                   mask[0] if ctx.masked else None, ctx.layout)
        return dqkv, None, None, None


def fused_attention(qkv: torch.Tensor, num_heads: int,
                    mask: Optional[torch.Tensor] = None,
                    layout: str = "packed") -> torch.Tensor:
    """Multi-head self-attention on packed ``(B, L, 3D)`` QKV → ``(B, L, D)``.

    CUDA tensors run the Hopper kernel of ``attention_route`` (no
    synchronisation, launched on the current stream) and count one launch in
    ``fused_attention.launches`` and in its route's entry of
    ``fused_attention.launches_by_route``; CPU tensors run
    ``attention_plain``. When ``qkv`` requires a gradient
    the call goes through ``FusedAttention``, whose backward is
    ``fused_attention_bwd``.
    """
    _check_args(qkv, num_heads, layout)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return FusedAttention.apply(qkv, num_heads, mask, layout)
    return _forward(qkv, num_heads, mask, layout)


fused_attention.launches = 0
fused_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
