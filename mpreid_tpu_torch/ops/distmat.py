"""Query×gallery distance matrices on the device.

ref mpreid_tpu/ops/distmat.py::euclidean_squared_distmat, ::cosine_distmat.
"""

from __future__ import annotations

import torch


def euclidean_squared_distmat(qf: torch.Tensor, gf: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distance ‖q‖² + ‖g‖² − 2·q·gᵀ in fp32 (the reference
    eval distmat is squared; only the triplet loss takes the root)."""
    qf = qf.float()
    gf = gf.float()
    qq = torch.sum(qf * qf, dim=1, keepdim=True)
    gg = torch.sum(gf * gf, dim=1, keepdim=True).T
    return qq + gg - 2.0 * (qf @ gf.T)


def cosine_distmat(qf: torch.Tensor, gf: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Arc-cosine distance (ref metrics.py:15-25)."""
    qf = qf.float()
    gf = gf.float()
    sim = qf @ gf.T
    qn = torch.linalg.norm(qf, dim=1, keepdim=True)
    gn = torch.linalg.norm(gf, dim=1, keepdim=True)
    sim = sim / (qn @ gn.T)
    return torch.arccos(torch.clamp(sim, -1 + epsilon, 1 - epsilon))
