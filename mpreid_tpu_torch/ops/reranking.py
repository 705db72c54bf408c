"""k-reciprocal re-ranking, dense (every set a multi-hot row over the corpus).

ref mpreid_tpu/ops/reranking.py::re_ranking, ::_multi_hot,
::_minsum_quantized, and the thresholds of
mpreid_tpu/ops/reranking_sparse.py::_quantile_thresholds.

With F the multi-hot (k1+1)-NN rows and Fh the (k1/2 + 1)-NN rows:
R = F ∧ Fᵀ, Rh = Fh ∧ Fhᵀ, C = R·Rhᵀ, R* = R ∨ [(R ∧ C > ⅔|Rh|)·Rh > 0],
V = rownorm(exp(−d) ∘ R*), V ← S·V (the k2-NN mean), and the Jaccard
distance from Σₖ min(Vᵢₖ, Vⱼₖ) = 1 − ½‖Vᵢ − Vⱼ‖₁ (rows of V sum to 1), so
the exact min-sum is ``ops/pairwise.py::l1_cross`` (the hand-written
Hopper kernel on the card). ``fast_minsum`` takes the 32-level threshold
decomposition instead: bf16 0/1 products summed in fp32.

The three N×N×N products stay fp32 ``torch.mm``: they are plain matrix
products that the JAX package leaves to XLA. At N = 19,281 (Market-1501)
each N×N fp32 matrix is 1.49 GB; dead ones are freed as the algorithm goes.

Neighbour lists break distance ties by the lower index, as
``jax.lax.top_k`` does (``smallest_k``), so duplicated features give the
JAX package's sets. Quantiles are computed as ``jnp.nanquantile`` computes
them (sort, linear interpolation in fp32): the same thresholds, and no size
limit (``torch.nanquantile`` refuses inputs above 2²⁴ elements).
"""

from __future__ import annotations

import numpy as np
import torch

from .distmat import euclidean_squared_distmat
from .matmul import mm_f32
from .pairwise import l1_cross

_FLOOR = 1e-9
LEVELS = 32


def multi_hot(indices: torch.Tensor, n: int) -> torch.Tensor:
    """(R, K) index rows → (R, n) 0/1 fp32 membership rows."""
    out = torch.zeros((indices.shape[0], n), dtype=torch.float32, device=indices.device)
    return out.scatter_(1, indices, 1.0)


def smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest entries of each row, ascending, ties by
    the lower index: the order of ``jax.lax.top_k(-d, k)``.

    ``torch.topk`` promises no order among equal values, so the selection
    is sorted by index and then stably by value; a row whose tie at the
    k-th value reaches past the selection is sorted whole, stably."""
    vals, idx = torch.topk(d, k, dim=1, largest=False, sorted=True)
    order = torch.argsort(idx, dim=1)
    vals, idx = vals.gather(1, order), idx.gather(1, order)
    idx = idx.gather(1, torch.sort(vals, dim=1, stable=True).indices)
    kth = vals.amax(dim=1, keepdim=True)
    straddle = torch.nonzero((d == kth).sum(1) > (vals == kth).sum(1)).flatten()
    if straddle.numel():
        idx[straddle] = torch.sort(d[straddle], dim=1, stable=True).indices[:, :k]
    return idx


def _nanquantile(x: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.nanquantile(x, qs)`` (linear) for 1-D fp32 ``x``, rounded as XLA
    compiles it: the interpolation is one fused multiply-add (exact in fp64
    before the one rounding to fp32)."""
    a = torch.sort(x).values  # NaN sorts last
    counts = (~torch.isnan(x)).sum().to(torch.float32)
    pos = qs * (counts - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, counts - 1)).long()
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, counts - 1)).long()
    lo_term = (a[low] * low_w).double()
    return (lo_term + a[high].double() * high_w.double()).float()


def quantile_thresholds(sample: torch.Tensor, levels: int = LEVELS):
    """Midpoints and widths of ``levels`` quantile intervals of the positive
    sample values (from 0) → (mids, deltas), fp32."""
    pos = torch.where(sample > _FLOOR, sample, torch.full_like(sample, float("nan")))
    # jnp.linspace(0, 1, levels) as XLA computes it: i · fp32(1 / (levels - 1)), then 1
    step = np.float32(1.0) / np.float32(levels - 1)
    qs = np.append(np.arange(levels - 1, dtype=np.float32) * step, np.float32(1.0))
    edges = _nanquantile(pos, torch.from_numpy(qs).to(sample.device))
    edges = torch.nan_to_num(edges, nan=_FLOOR)
    edges = torch.cat([edges.new_zeros(1), edges])
    lows, highs = edges[:-1], edges[1:]
    mids = torch.clamp(0.5 * (lows + highs), min=_FLOOR)
    return mids, highs - lows


def _ceil_bf16(t: torch.Tensor) -> torch.Tensor:
    """The least bf16 value ≥ each positive fp32 ``t``: for bf16 ``x``,
    ``x ≥ t`` compared in fp32 (as JAX promotes) ⟺ ``x ≥ _ceil_bf16(t)``
    (PyTorch would compare a bf16 tensor with ``t`` rounded to bf16)."""
    r = t.to(torch.bfloat16)
    up = (r.view(torch.int16) + 1).view(torch.bfloat16)
    return torch.where(r.float() < t, up, r)


def minsum_levels(vq: torch.Tensor, vg: torch.Tensor, mids, deltas) -> torch.Tensor:
    """(Q, G) Σ_l Δ_l · (1[vq ≥ t_l] @ 1[vg ≥ t_l]ᵀ): bf16 0/1 products,
    exact counts summed in fp32. ``vq`` and ``vg`` are both fp32 or both
    bf16; the comparisons are those of fp32 either way."""
    if vq.dtype == torch.bfloat16:
        mids = _ceil_bf16(mids)
    out = torch.zeros((vq.shape[0], vg.shape[0]), dtype=torch.float32, device=vq.device)
    for t, d in zip(mids, deltas):
        a = (vq >= t).to(torch.bfloat16)
        b = (vg >= t).to(torch.bfloat16)
        out = out + d * mm_f32(a, b.T)
    return out


def minsum_quantized(vq: torch.Tensor, vg: torch.Tensor, levels: int = LEVELS) -> torch.Tensor:
    """Approximate Σₖ min(vqᵢₖ, vgⱼₖ): min(a, b) = ∫ [a ≥ t][b ≥ t] dt at
    ``levels`` thresholds, the quantiles of the first 128 rows of each side."""
    sample = torch.cat([vq[: min(vq.shape[0], 128)].reshape(-1),
                        vg[: min(vg.shape[0], 128)].reshape(-1)])
    mids, deltas = quantile_thresholds(sample, levels)
    return minsum_levels(vq, vg, mids, deltas)


def re_ranking(qf: torch.Tensor, gf: torch.Tensor, k1: int = 50, k2: int = 15,
               lambda_value: float = 0.3, fast_minsum: bool = False) -> torch.Tensor:
    """Re-ranked (Q, G) distance matrix from query and gallery features, fp32
    on their device (the reference's ``re_ranking(probFea, galFea, k1, k2, λ)``).
    ``fast_minsum`` swaps the exact L1 Jaccard step for the quantized one."""
    feat = torch.cat([qf, gf], dim=0).float()
    num_q = qf.shape[0]
    n = feat.shape[0]

    orig = euclidean_squared_distmat(feat, feat)
    orig = (orig / orig.amax(dim=0)).T.contiguous()

    # clamp neighbour counts to the corpus size (the reference's NumPy
    # slicing truncates silently for tiny galleries)
    k1 = min(k1, n - 1)
    k2 = min(k2, n)
    half = int(round(k1 / 2))
    k_top = max(k1 + 1, half + 1, k2)
    nn = smallest_k(orig, k_top)

    f_full = multi_hot(nn[:, : k1 + 1], n)
    r_full = f_full * f_full.T
    del f_full
    f_half = multi_hot(nn[:, : half + 1], n)
    r_half = f_half * f_half.T
    del f_half

    overlap = torch.mm(r_full, r_half.T)
    half_sizes = r_half.sum(dim=1)
    cond = r_full * (overlap > (2.0 / 3.0) * half_sizes[None, :])
    del overlap
    expanded = torch.clamp(r_full + torch.mm(cond, r_half), 0.0, 1.0)
    del cond, r_full, r_half

    v = torch.exp(-orig) * expanded
    del expanded
    v = v / v.sum(dim=1, keepdim=True)

    if k2 != 1:
        s = multi_hot(nn[:, :k2], n) / k2
        v = torch.mm(s, v)
        del s

    if fast_minsum:
        min_sums = minsum_quantized(v[:num_q], v[num_q:])
    else:
        min_sums = 1.0 - 0.5 * l1_cross(v[:num_q], v[num_q:])
    del v
    jaccard = 1.0 - min_sums / (2.0 - min_sums)
    return jaccard * (1 - lambda_value) + orig[:num_q, num_q:] * lambda_value
