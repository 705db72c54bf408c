"""Gallery-sharded evaluation over the ranks.

ref mpreid_tpu/parallel/sharded_eval.py::sharded_distmat, ::sharded_topk,
::sharded_cmc_map, ::_sharded_cmc_map_impl.

Each rank holds one contiguous block of the gallery (blocks of one size; the
caller pads, as ``engine/processor.py::run_validation`` does) and every
query. The (Q, G) distance matrix is never formed on one rank:

* ``sharded_distmat``: this rank's (Q, G/ranks) slab;
* ``sharded_topk``: each rank's k nearest, all-gathered, merged;
* ``sharded_cmc_map``: exact CMC and mAP from counts. Each rank sorts its
  slab (stably) and contributes its relevant items as thresholds, given as
  (distance, global gallery index) pairs; every rank counts, for every
  threshold, its kept and its relevant items that come before it in the
  dense path's order, and the counts are summed over the ranks. That order
  is a stable argsort of the full row, i.e. lexicographic by (distance,
  global gallery index), ties between a relevant and an irrelevant item at
  one distance included; ``count_lex`` reproduces it exactly.

``psum`` becomes ``collectives.all_reduce_sum`` and the tiled
``all_gather`` along axis 1 a ``collectives.all_gather`` of the transpose.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mpreid_tpu_torch.ops.distmat import euclidean_squared_distmat

from . import collectives as C
from .mesh import Mesh


def sharded_distmat(qf: torch.Tensor, gf_block: torch.Tensor) -> torch.Tensor:
    """(Q, G/ranks) squared euclidean distances to this rank's gallery block."""
    return euclidean_squared_distmat(qf, gf_block)


def _gather_cols(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' (Q, k) blocks side by side, rank by rank → (Q, ranks·k)."""
    return C.all_gather(x.t().contiguous(), mesh.group).t().contiguous()


def sharded_topk(qf: torch.Tensor, gf_block: torch.Tensor, k: int, mesh: Mesh
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global k nearest gallery items per query → (distances, global indices)."""
    d = sharded_distmat(qf, gf_block)
    vals, idx = torch.topk(-d, k, dim=1)
    gidx = idx + mesh.rank * d.shape[1]
    vals_all, gidx_all = _gather_cols(vals, mesh), _gather_cols(gidx, mesh)
    mvals, mpos = torch.topk(vals_all, k, dim=1)
    return -mvals, gidx_all.gather(1, mpos)


def _block_cap(g_pids_block: torch.Tensor, mesh: Mesh) -> int:
    """The most gallery items of one identity in any rank's block: the most
    relevant items a query can have in one block."""
    counts = torch.unique(g_pids_block, return_counts=True)[1]
    local = counts.max().reshape(1) if counts.numel() else counts.new_ones(1)
    return int(C.all_gather(local, mesh.group).max())


def sharded_cmc_map(qf: torch.Tensor, gf_block: torch.Tensor, q_pids: torch.Tensor,
                    g_pids_block: torch.Tensor, q_camids: torch.Tensor,
                    g_camids_block: torch.Tensor, mesh: Mesh, max_rank: int = 50,
                    camera_filter: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (cmc[max_rank], mAP) of the queries against the gallery whose
    block of one size each rank holds (labels on the features' device),
    the same on every rank. ``max_rank`` is clamped to the whole gallery."""
    qf, gf_block = qf.float(), gf_block.float()
    d = sharded_distmat(qf, gf_block)                            # (Q, Gs)
    gs = d.shape[1]
    g_total = gs * mesh.data
    match = g_pids_block[None, :] == q_pids[:, None]
    if camera_filter:
        keep = ~(match & (g_camids_block[None, :] == q_camids[:, None]))
    else:
        keep = torch.ones_like(match)
    mk = match & keep
    num_rel = C.all_reduce_sum(mk.sum(dim=1), mesh.group)       # (Q,)
    k = min(gs, _block_cap(g_pids_block, mesh))
    inf = torch.full((), float("inf"), device=d.device)

    def sort_with_gidx(masked):
        sd, order = torch.sort(masked, dim=1, stable=True)
        return sd, mesh.rank * gs + order                        # global indices

    d_rel, g_rel = sort_with_gidx(torch.where(mk, d, inf))
    d_kept, g_kept = sort_with_gidx(torch.where(keep, d, inf))
    thr_d = _gather_cols(d_rel[:, :k].contiguous(), mesh)       # (Q, ranks·k)
    thr_g = _gather_cols(g_rel[:, :k].contiguous(), mesh)

    # count_lex(t, tg) = #items with d < t, plus #items in t's tie window
    # with a smaller global index. The window count uses a per-position key
    # m[p] = tie_window_start(p)·G + gidx[p], non-decreasing because the
    # stable sort leaves gidx ascending within a window: searchsorted(m,
    # left_t·G + tg) − left_t counts the window's smaller-index ties, gated
    # on the window at left_t holding t (when t is absent from this block the
    # target lands in the next window and the raw difference would
    # overcount). The key is int64, whose range no gallery reaches: the JAX
    # package's int32 overflow guard (``_tie_key_dtype``) has nothing to
    # guard here.
    def count_lex(sd, sg):
        self_left = torch.searchsorted(sd, sd, side="left")
        m = self_left * g_total + sg
        left_t = torch.searchsorted(sd, thr_d, side="left")
        raw = torch.searchsorted(m, left_t * g_total + thr_g)
        raw = torch.clamp(raw - left_t, min=0)
        at_left = sd.gather(1, torch.clamp(left_t, max=gs - 1))
        return left_t + torch.where(at_left == thr_d, raw, torch.zeros_like(raw))

    # rank(t) = 1 + #kept before t; cnt_rel(t) = 1 + #relevant before t
    ranks = C.all_reduce_sum(count_lex(d_kept, g_kept), mesh.group) + 1
    cnt_rel = C.all_reduce_sum(count_lex(d_rel, g_rel), mesh.group) + 1

    valid_t = torch.isfinite(thr_d)
    prec = torch.where(valid_t, cnt_rel.float() / ranks.float(), torch.zeros((), device=d.device))
    ap_sum = prec.sum(dim=1)
    big = torch.iinfo(torch.int64).max
    first = torch.where(valid_t, ranks, torch.full_like(ranks, big)).amin(dim=1)

    valid = num_rel > 0
    n_valid = valid.sum().float()
    ap = ap_sum / torch.clamp(num_rel, min=1).float()
    mean_ap = torch.where(valid, ap, torch.zeros_like(ap)).sum() / n_valid
    rank_axis = torch.arange(1, min(max_rank, g_total) + 1, device=d.device)
    cmc_per_q = (first[:, None] <= rank_axis[None, :]).float()
    cmc = torch.where(valid[:, None], cmc_per_q, torch.zeros_like(cmc_per_q)).sum(dim=0) / n_valid
    return cmc, mean_ap
