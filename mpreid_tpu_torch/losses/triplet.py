"""Batch-hard triplet loss.

ref mpreid_tpu/losses/triplet.py::euclidean_dist, ::hard_example_mining,
::triplet_loss.

The hardest positive and negative are taken with ``amax``/``amin`` over
masked distances, which share a tie's gradient among the tied entries as
JAX's max does (``max(dim)`` indices would give it to one). The hinge is
``torch.maximum`` and the soft margin ``logaddexp(x, 0)``, JAX's forms.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt(max(‖x‖² + ‖y‖² − 2·x·yᵀ, 1e-12)), (N, M)."""
    xx = torch.sum(torch.square(x), dim=1, keepdim=True)
    yy = torch.sum(torch.square(y), dim=1, keepdim=True).t()
    dist = xx + yy - 2.0 * torch.matmul(x, y.t())
    return torch.sqrt(torch.clamp(dist, min=1e-12))


def hard_example_mining(dist_mat: torch.Tensor, labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per anchor: the largest distance to a same-label sample and the
    smallest to another-label sample."""
    is_pos = labels[:, None] == labels[None, :]
    neg_inf = torch.full_like(dist_mat, float("-inf"))
    pos_inf = torch.full_like(dist_mat, float("inf"))
    dist_ap = torch.amax(torch.where(is_pos, dist_mat, neg_inf), dim=1)
    dist_an = torch.amin(torch.where(is_pos, pos_inf, dist_mat), dim=1)
    return dist_ap, dist_an


def triplet_loss(global_feat: torch.Tensor, labels: torch.Tensor,
                 margin: Optional[float] = None, hard_factor: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (loss, dist_ap, dist_an): margin ranking loss with ``margin``, the
    soft margin without."""
    feat = global_feat.float()
    dist_ap, dist_an = hard_example_mining(euclidean_dist(feat, feat), labels)
    dist_ap = dist_ap * (1.0 + hard_factor)
    dist_an = dist_an * (1.0 - hard_factor)
    x = dist_ap - dist_an
    zero = torch.zeros_like(x)
    if margin is not None:
        loss = torch.mean(torch.maximum(x + margin, zero))
    else:
        loss = torch.mean(torch.logaddexp(x, zero))
    return loss, dist_ap, dist_an
