"""Matrix products summed in fp32.

ref ``jnp.dot``/``jnp.einsum(..., preferred_element_type=jnp.float32)`` as
the JAX package uses them in its layers (mpreid_tpu/models/layers.py),
re-ranking's 0/1 threshold products
(mpreid_tpu/ops/reranking.py::_minsum_quantized) and the RN50 attention
pool (mpreid_tpu/models/resnet.py::AttentionPool2d). A bf16 ``a @ b`` in
PyTorch returns bf16, which would round the sums.
"""

from __future__ import annotations

import torch


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2-D ``a @ b`` summed in fp32, fp32 result."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        # bf16 operands, fp32 accumulation and fp32 result in one GEMM
        return torch.mm(a, b, out_dtype=torch.float32)
    # products of two bf16 values are exact in fp32 (no CPU kernel takes out_dtype)
    return torch.mm(a.float(), b.float())


def _bmm_sum_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` over equal leading dims, summed in fp32, fp32 result:
    one bf16 GEMM with fp32 accumulation when both operands are bf16 (on the
    card), else an fp32 GEMM of the operands as they are in fp32."""
    lead = a.shape[:-2]
    a3, b3 = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    if a.dtype == b.dtype != torch.float32:
        out = torch.bmm(a3, b3, out_dtype=torch.float32)
    else:
        out = torch.bmm(a3.float(), b3.float())
    return out.reshape(*lead, *out.shape[-2:])


class _BmmF32(torch.autograd.Function):
    """``bmm_f32`` on the card, with the VJP of JAX's ``einsum(...,
    preferred_element_type=float32)``: each gradient is the cotangent (in
    ``out_dtype``) times the other operand, summed in fp32 and rounded to
    the operand's dtype. A bf16 cotangent (``out_dtype`` bf16) keeps the
    backward's products on bf16 operands too; an fp32 one takes them in fp32."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _bmm_sum_f32(a, b).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b, _ = ctx.needs_input_grad
        da = _bmm_sum_f32(g, b.transpose(-1, -2)).to(a.dtype) if need_a else None
        db = _bmm_sum_f32(a.transpose(-1, -2), g).to(b.dtype) if need_b else None
        return da, db, None


def bmm_f32(a: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Batched ``a @ b`` (the same leading dims on both) summed in fp32 and
    rounded to ``out_dtype``; differentiable. bf16 operands on the card go
    through one bf16 GEMM with fp32 accumulation and no fp32 copies."""
    if a.is_cuda and a.dtype != torch.float32:
        return _BmmF32.apply(a, b, out_dtype)
    # products of two bf16 values are exact in fp32 (no CPU kernel takes out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)
