"""Matrix product summed in fp32 with an fp32 result.

ref ``jnp.dot(..., preferred_element_type=jnp.float32)`` as the JAX
package's layers (mpreid_tpu/models/layers.py) and re-ranking's 0/1
threshold products (mpreid_tpu/ops/reranking.py::_minsum_quantized) use it.
A bf16 ``a @ b`` in PyTorch returns bf16, which would round the sums.
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
