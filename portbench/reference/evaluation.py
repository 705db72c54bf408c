"""Re-identification metrics: squared Euclidean distances between
L2-normalised query and gallery features, CMC (first correct match at rank
≤ r) and mAP over the gallery in distance order, every gallery image
counted (no same-camera filter, as the configuration sets it)."""

from __future__ import annotations

import torch


def normalised(f):
    return f / torch.linalg.norm(f, dim=1, keepdim=True)


def distances(qf, gf):
    return ((qf * qf).sum(1)[:, None] + (gf * gf).sum(1)[None, :] - 2.0 * qf @ gf.t())


def cmc_map(dist, q_pids, g_pids, max_rank: int = 50, rows: int = 256):
    """→ (cmc (max_rank,) fp64, mAP) over the queries with a match."""
    hits = torch.zeros(max_rank, dtype=torch.float64, device=dist.device)
    ap_sum, valid = 0.0, 0
    for lo in range(0, dist.shape[0], rows):
        d = dist[lo:lo + rows]
        order = torch.argsort(d, dim=1, stable=True)
        match = (g_pids[order] == q_pids[lo:lo + rows, None]).double()
        n_rel = match.sum(1)
        ok = n_rel > 0
        ranks = torch.arange(1, match.shape[1] + 1, device=d.device, dtype=torch.float64)
        precision = torch.cumsum(match, 1) / ranks
        ap = (precision * match).sum(1) / n_rel.clamp(min=1)
        first = torch.argmax(match, dim=1)
        for r in range(max_rank):
            hits[r] += ((first <= r) & ok).sum()
        ap_sum += float(ap[ok].sum())
        valid += int(ok.sum())
    return hits / valid, ap_sum / valid
