"""k-reciprocal re-ranking with sparse V rows, for corpora whose N×N
matrices do not fit on the card (MSMT17: N = 93,820, 35 GB per matrix).

ref mpreid_tpu/ops/reranking_sparse.py::re_ranking_sparse,
::re_ranking_sparse_rows, ::_topk_neighbors, ::_reciprocal_mask,
::_dedup_compact, ::_expand_rows, ::_query_expand, ::_densify,
::_minsum_exact, ::_final_blend_chunks, ::_resolve_params,
::_build_sparse_v; ::_quantile_thresholds and ::_minsum_quantized_chunk
are ops/reranking.py's ``quantile_thresholds`` and ``minsum_levels``.

No N×N matrix is ever held:

1. neighbours: row blocks of the distance matrix, top-(k_top) indices and
   the row max (the column max of the symmetric matrix);
2. reciprocity: blocked gathers of the back-neighbour lists → masks of
   width k1+1 and half+1;
3. expansion: reciprocal set ∪ accepted half sets, sorted, deduplicated and
   compacted to a fixed width W, weights exp(−d/colmax) on that support;
4. query expansion: the k2 neighbours' rows merged sparsely (stable sort
   by index, segmented sum) and compacted to W2;
5. min-sum, Jaccard and λ-blend a query block × gallery chunk at a time,
   each block written in place into one (Q, G) result. ``minsum="exact"``
   runs ``ops/pairwise.py::minsum_cross`` (the hand-written Hopper kernel
   on the card) on densified fp32 rows; ``"quantized"`` the 32-level
   threshold decomposition on bf16 rows.

The JAX package's ``lax.map``/``fori_loop`` over blocks and chunks are
Python loops here, and its donated result is one ``torch.empty`` that each
block writes into. The last query block and the last gallery chunk start
at ``Q − q_block`` and ``G − g_chunk``: they overlap the one before and
recompute the same values, so nothing is padded. Widths overflow
deterministically (the highest sorted indices drop) and ``return_info``
counts the rows that did. The mesh-sharded ``re_ranking_sparse_sharded``
waits for the parallel modes.
"""

from __future__ import annotations

from typing import Optional

import torch

from .pairwise import minsum_cross
from .reranking import minsum_levels, quantile_thresholds, smallest_k


def _row_blocks(n: int, block: int):
    for lo in range(0, n, block):
        yield lo, min(lo + block, n)


# stage 1 -------------------------------------------------------------------

def _topk_neighbors(feat: torch.Tensor, k_top: int, block: int):
    """→ ``nn`` (N, k_top) ascending-distance neighbour indices (self first,
    ties by lower index) and ``colmax`` (N,), the row max of the squared
    distances (the column max of the symmetric matrix), floored at 1e-12."""
    n = feat.shape[0]
    sq = torch.sum(feat * feat, dim=1)
    nn = torch.empty((n, k_top), dtype=torch.long, device=feat.device)
    colmax = torch.empty(n, dtype=torch.float32, device=feat.device)
    for lo, hi in _row_blocks(n, block):
        d = sq[lo:hi, None] + sq[None, :] - 2.0 * torch.mm(feat[lo:hi], feat.T)
        d = torch.clamp(d, min=0.0)
        colmax[lo:hi] = d.amax(dim=1)
        nn[lo:hi] = smallest_k(d, k_top)
    return nn, torch.clamp(colmax, min=1e-12)


# stage 2 -------------------------------------------------------------------

def _reciprocal_mask(nn: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """mask[a, i] = (a ∈ k-NN of nn[a, i]) for i < k+1."""
    n = nn.shape[0]
    mask = torch.empty((n, k + 1), dtype=torch.bool, device=nn.device)
    for lo, hi in _row_blocks(n, block):
        back = nn[nn[lo:hi, : k + 1], : k + 1]  # (B, K, K)
        rows = torch.arange(lo, hi, device=nn.device)
        mask[lo:hi] = (back == rows[:, None, None]).any(dim=-1)
    return mask


# helpers -------------------------------------------------------------------

def _dedup_compact(idx_sorted: torch.Tensor, width: int, sentinel: int):
    """Row-wise: keep the first of each run of an index-sorted row, write
    them to the first ``width`` slots (the rest ``sentinel``) → (idx, overflow).
    Past ``width`` the highest indices drop. Dropped and repeated entries
    all go to one extra column, sliced away."""
    b = idx_sorted.shape[0]
    valid = idx_sorted < sentinel
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=idx_sorted.device),
                       idx_sorted[:, 1:] != idx_sorted[:, :-1]], dim=1) & valid
    pos = torch.cumsum(first.to(torch.int32), dim=1) - 1
    overflow = torch.clamp(first.sum(dim=1) - width, min=0)
    tgt = torch.clamp(torch.where(first, pos, width), max=width).long()
    out = torch.full((b, width + 1), sentinel, dtype=idx_sorted.dtype,
                     device=idx_sorted.device)
    out.scatter_(1, tgt, torch.where(first, idx_sorted, torch.full_like(idx_sorted, sentinel)))
    return out[:, :width], overflow


# stage 3 -------------------------------------------------------------------

def _expand_rows(feat, nn, colmax, rmask, hmask, k1, half, width, block):
    """Sparse V0 → (idx (N, W) int64, val (N, W) fp32, overflow (N,))."""
    n = feat.shape[0]
    sentinel = n
    k, h = k1 + 1, half + 1
    sq = torch.sum(feat * feat, dim=1)
    idx0 = torch.empty((n, width), dtype=torch.long, device=feat.device)
    val0 = torch.empty((n, width), dtype=torch.float32, device=feat.device)
    ovf = torch.empty(n, dtype=torch.long, device=feat.device)
    for lo, hi in _row_blocks(n, block):
        c_b, rm_b = nn[lo:hi, :k], rmask[lo:hi]           # (B, K)
        # half sets of each reciprocal member
        hidx = nn[c_b, :h]                                 # (B, K, H)
        hval = hmask[c_b] & rm_b[:, :, None]               # (B, K, H)
        # |Rh(b) ∩ R(a)| > 2/3 |Rh(b)|
        r_set = torch.where(rm_b, c_b, torch.full_like(c_b, sentinel))
        inter = (hidx[:, :, :, None] == r_set[:, None, None, :]).any(dim=-1) & hval
        n_inter = inter.sum(dim=-1).to(torch.float32)
        n_half = hval.sum(dim=-1).to(torch.float32)
        accept = rm_b & (n_inter > (2.0 / 3.0) * n_half)
        slots = torch.cat([
            r_set,
            torch.where(accept[:, :, None] & hval, hidx,
                        torch.full_like(hidx, sentinel)).reshape(hi - lo, -1),
        ], dim=1)
        slots = torch.sort(slots, dim=1).values
        idx_c, ovf[lo:hi] = _dedup_compact(slots, width, sentinel)

        # weights exp(−d/colmax[a]) on the compacted support only
        safe = torch.clamp(idx_c, max=n - 1)
        fc = feat[safe]                                    # (B, W, D)
        dots = torch.bmm(fc, feat[lo:hi, :, None])[..., 0]
        d = sq[lo:hi, None] + sq[safe] - 2.0 * dots
        d = torch.clamp(d, min=0.0) / colmax[lo:hi, None]
        w = torch.where(idx_c < sentinel, torch.exp(-d), torch.zeros_like(d))
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-12)
        idx0[lo:hi], val0[lo:hi] = idx_c, w
    return idx0, val0, ovf


# stage 4 -------------------------------------------------------------------

def _query_expand(idx0, val0, nn, k2, width2, block):
    """V1[a] = mean of V0 over a's k2-NN, merged sparsely → (idx, val, overflow)."""
    n = idx0.shape[0]
    sentinel = n
    if k2 == 1:
        return idx0, val0, torch.zeros(n, dtype=torch.long, device=idx0.device)
    idx1 = torch.empty((n, width2), dtype=torch.long, device=idx0.device)
    val1 = torch.empty((n, width2), dtype=torch.float32, device=idx0.device)
    ovf = torch.empty(n, dtype=torch.long, device=idx0.device)
    for lo, hi in _row_blocks(n, block):
        nn_b = nn[lo:hi, :k2]
        b = hi - lo
        gi = idx0[nn_b].reshape(b, -1)                     # (B, k2·W)
        gv = (val0[nn_b] / k2).reshape(b, -1)
        # stable: the order of equal indices sets the running sums below
        order = torch.argsort(gi, dim=1, stable=True)
        gi, gv = gi.gather(1, order), gv.gather(1, order)
        # segmented sum of duplicate indices: running-sum difference at run ends
        last = torch.cat([gi[:, :-1] != gi[:, 1:],
                          torch.ones((b, 1), dtype=torch.bool, device=gi.device)],
                         dim=1) & (gi < sentinel)
        csum = torch.cumsum(gv, dim=1)
        pos = torch.cumsum(last.to(torch.int32), dim=1) - 1
        ovf[lo:hi] = torch.clamp(last.sum(dim=1) - width2, min=0)
        tgt = torch.clamp(torch.where(last, pos, width2), max=width2).long()
        idx_m = torch.full((b, width2 + 1), sentinel, dtype=gi.dtype, device=gi.device)
        idx_m.scatter_(1, tgt, torch.where(last, gi, torch.full_like(gi, sentinel)))
        cs_m = torch.zeros((b, width2 + 1), dtype=torch.float32, device=gi.device)
        cs_m.scatter_(1, tgt, torch.where(last, csum, torch.zeros_like(csum)))
        idx_m, cs_m = idx_m[:, :width2], cs_m[:, :width2]
        val_m = torch.diff(cs_m, dim=1, prepend=cs_m.new_zeros((b, 1)))
        idx1[lo:hi] = idx_m
        val1[lo:hi] = torch.where(idx_m < sentinel, val_m, torch.zeros_like(val_m))
    return idx1, val1, ovf


# stage 5 -------------------------------------------------------------------

def _densify(idx: torch.Tensor, val: torch.Tensor, n: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, W) sparse rows → (B, n) dense. Indices are unique per row; the
    sentinel slots all write 0 to column n, which is sliced away (the result
    is a view with row stride n + 1)."""
    out = torch.zeros((idx.shape[0], n + 1), dtype=dtype, device=idx.device)
    return out.scatter_(1, idx, val.to(dtype))[:, :n]


def _minsum_exact(vq_dense, idxg, valg, n, g_chunk) -> torch.Tensor:
    """(Q, G) exact Σ min: the gallery densified a chunk at a time against
    the dense query rows (the last chunk is ragged; the kernel masks it)."""
    g = idxg.shape[0]
    out = torch.empty((vq_dense.shape[0], g), dtype=torch.float32, device=vq_dense.device)
    for lo, hi in _row_blocks(g, g_chunk):
        out[:, lo:hi] = minsum_cross(vq_dense, _densify(idxg[lo:hi], valg[lo:hi], n))
    return out


def _final_blend_chunks(out, rows, vq_dense, qf32, colmax_q, gf32, idxg, valg, n,
                        g_chunk, lambda_value, minsum, thresholds) -> None:
    """Min-sum → Jaccard → λ-blend of query rows ``rows`` (a slice of
    ``out``'s rows), one gallery chunk at a time, written into ``out``."""
    g = idxg.shape[0]
    g_chunk = min(g_chunk, g)
    sqq = torch.sum(qf32 * qf32, dim=1)
    for i in range(-(-g // g_chunk)):
        start = min(i * g_chunk, g - g_chunk)
        sl = slice(start, start + g_chunk)
        if minsum == "quantized":
            # bf16 rows halve the bytes; the comparisons re-quantise to 0/1
            vg_dense = _densify(idxg[sl], valg[sl], n, torch.bfloat16)
            ms = minsum_levels(vq_dense, vg_dense, *thresholds)
        else:
            ms = minsum_cross(vq_dense, _densify(idxg[sl], valg[sl], n))
        jac = 1.0 - ms / (2.0 - ms)                        # (rows, chunk)
        gfc = gf32[sl]
        d = sqq[:, None] + torch.sum(gfc * gfc, dim=1)[None, :] - 2.0 * torch.mm(qf32, gfc.T)
        orig = torch.clamp(d, min=0.0) / colmax_q[:, None]
        out[rows, sl] = jac * (1 - lambda_value) + orig * lambda_value


# public entry ----------------------------------------------------------------

def _resolve_params(n, k1, k2, width, width2):
    k1 = min(k1, n - 1)
    k2 = min(k2, n)
    half = int(round(k1 / 2))
    if width is None:
        width = min(8 * (k1 + 1), (k1 + 1) * (half + 2))
    if width2 is None:
        width2 = min(4 * width, max(k2, 1) * width)
    width2 = max(width2, width)
    return k1, k2, half, width, width2


def _build_sparse_v(feat, k1, k2, half, width, width2, block):
    """Stages 1-4 → (idx1 (N, W2), val1 (N, W2), colmax (N,), ovf_v, ovf_qe)."""
    k_top = max(k1 + 1, half + 1, k2)
    nn, colmax = _topk_neighbors(feat, k_top, block)
    rmask = _reciprocal_mask(nn, k1, block)
    hmask = _reciprocal_mask(nn, half, block)
    idx0, val0, ovf_v = _expand_rows(feat, nn, colmax, rmask, hmask, k1, half, width, block)
    idx1, val1, ovf_qe = _query_expand(idx0, val0, nn, k2, width2, block)
    return idx1, val1, colmax, ovf_v, ovf_qe


def re_ranking_sparse(qf: torch.Tensor, gf: torch.Tensor, k1: int = 50, k2: int = 15,
                      lambda_value: float = 0.3, width: Optional[int] = None,
                      width2: Optional[int] = None, minsum: str = "exact", block: int = 256,
                      g_chunk: int = 4096, q_block: int = 2048, return_info: bool = False):
    """Re-ranked (Q, G) distance matrix, fp32 on the features' device, with
    O(N·W) memory besides the result (same semantics as ``re_ranking``).

    ``minsum``: ``"exact"`` (elementwise min over densified gallery chunks)
    or ``"quantized"`` (32-level threshold decomposition, the evaluator's
    choice at large N). ``width``/``width2`` cap the expanded and
    query-expanded supports (defaults 8·(k1+1) and 4·width);
    ``return_info=True`` also returns ``{"overflow_v": rows truncated at
    stage 3, "overflow_qe": rows truncated at stage 4}``."""
    if minsum not in ("exact", "quantized"):
        raise ValueError(f"minsum must be 'exact'|'quantized', got {minsum!r}")
    feat = torch.cat([qf, gf], dim=0).float()
    num_q, num_g = qf.shape[0], gf.shape[0]
    n = feat.shape[0]
    k1, k2, half, width, width2 = _resolve_params(n, k1, k2, width, width2)

    idx1, val1, colmax, ovf_v, ovf_qe = _build_sparse_v(feat, k1, k2, half, width, width2,
                                                        block)
    thresholds = (quantile_thresholds(val1[: min(n, 256)].reshape(-1))
                  if minsum == "quantized" else None)
    q_dtype = torch.float32 if minsum == "exact" else torch.bfloat16
    idxg, valg, gf32 = idx1[num_q:], val1[num_q:], feat[num_q:]

    q_block = min(q_block, num_q)
    out = torch.empty((num_q, num_g), dtype=torch.float32, device=feat.device)
    for i in range(-(-num_q // q_block)):
        start = min(i * q_block, num_q - q_block)
        rows = slice(start, start + q_block)
        vq_dense = _densify(idx1[rows], val1[rows], n, q_dtype)
        _final_blend_chunks(out, rows, vq_dense, feat[rows], colmax[rows], gf32, idxg, valg,
                            n, g_chunk, lambda_value, minsum, thresholds)
        del vq_dense
    if return_info:
        return out, {"overflow_v": int((ovf_v > 0).sum()),
                     "overflow_qe": int((ovf_qe > 0).sum())}
    return out


def re_ranking_sparse_rows(qf: torch.Tensor, gf: torch.Tensor, rows, k1: int = 50,
                           k2: int = 15, lambda_value: float = 0.3,
                           width: Optional[int] = None, width2: Optional[int] = None,
                           block: int = 256, g_chunk: int = 4096) -> torch.Tensor:
    """Exact re-ranked distances of the query rows ``rows`` → (len(rows), G):
    the same sparse-V construction over the whole corpus, then the exact
    min-sum for those rows only. The oracle that holds the quantized matrix
    at corpus sizes where neither the dense path nor the NumPy oracle runs."""
    feat = torch.cat([qf, gf], dim=0).float()
    num_q = qf.shape[0]
    n = feat.shape[0]
    k1, k2, half, width, width2 = _resolve_params(n, k1, k2, width, width2)

    idx1, val1, colmax, _, _ = _build_sparse_v(feat, k1, k2, half, width, width2, block)
    rows = torch.as_tensor(rows, device=feat.device).long()
    vq_dense = _densify(idx1[rows], val1[rows], n)
    ms = _minsum_exact(vq_dense, idx1[num_q:], val1[num_q:], n, g_chunk)
    jaccard = 1.0 - ms / (2.0 - ms)

    qfr = feat[:num_q][rows]
    gfr = feat[num_q:]
    d_qg = (torch.sum(qfr ** 2, dim=1)[:, None] + torch.sum(gfr ** 2, dim=1)[None, :]
            - 2.0 * torch.mm(qfr, gfr.T))
    orig_qg = torch.clamp(d_qg, min=0.0) / colmax[rows][:, None]
    return jaccard * (1 - lambda_value) + orig_qg * lambda_value
