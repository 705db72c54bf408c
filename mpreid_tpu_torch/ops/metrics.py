"""CMC / mAP evaluation, vectorised on the device.

ref mpreid_tpu/ops/metrics.py::cmc_map. Protocol as there:
  * ``camera_filter=False`` (the reference's default) keeps same-pid
    same-camera gallery entries; ``True`` removes them per query,
  * queries whose identity never appears in the kept gallery are left out
    of both CMC and mAP,
  * ``max_rank`` is clamped to the gallery size.
The sort is stable (as ``jnp.argsort``), so ties break the same way.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cmc_map(distmat: torch.Tensor, q_pids: torch.Tensor, g_pids: torch.Tensor,
            q_camids: torch.Tensor, g_camids: torch.Tensor, max_rank: int = 50,
            camera_filter: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (cmc[max_rank], mAP)."""
    num_q, num_g = distmat.shape
    max_rank = min(max_rank, num_g)
    indices = torch.argsort(distmat, dim=1, stable=True)
    matches = g_pids[indices] == q_pids[:, None]
    if camera_filter:
        keep = ~(matches & (g_camids[indices] == q_camids[:, None]))
    else:
        keep = torch.ones_like(matches)
    mk = matches & keep
    # 1-based rank of each gallery entry within the kept subsequence
    rank_in_kept = torch.cumsum(keep.to(torch.int32), dim=1)
    num_rel = mk.sum(dim=1)
    cum_matches = torch.cumsum(mk.to(torch.int32), dim=1)

    # average precision over the kept sequence
    precision_at_hit = torch.where(
        mk, cum_matches.float() / rank_in_kept.float(), torch.zeros((), device=distmat.device)
    )
    ap = precision_at_hit.sum(dim=1) / torch.clamp(num_rel, min=1).float()
    valid = num_rel > 0
    n_valid = valid.sum().float()
    mean_ap = torch.where(valid, ap, torch.zeros_like(ap)).sum() / n_valid

    # CMC: rank of the first kept match
    first_hit = torch.where(mk, rank_in_kept, torch.full_like(rank_in_kept, num_g + 1)).amin(dim=1)
    ranks = torch.arange(1, max_rank + 1, device=distmat.device)
    cmc_per_q = (first_hit[:, None] <= ranks[None, :]).float()
    cmc = torch.where(valid[:, None], cmc_per_q, torch.zeros_like(cmc_per_q)).sum(dim=0) / n_valid
    return cmc, mean_ap
