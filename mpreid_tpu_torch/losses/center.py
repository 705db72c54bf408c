"""Center loss.

ref mpreid_tpu/losses/center.py::init_centers, ::center_loss. The centers
are a (num_classes, feat_dim) tensor stepped by their own SGD
(solver/optim.py::CenterOptimizer); the loss is a pure function.
"""

from __future__ import annotations

import torch


def init_centers(gen: torch.Generator, num_classes: int, feat_dim: int = 2048) -> torch.Tensor:
    return torch.randn((num_classes, feat_dim), generator=gen, dtype=torch.float32)


def center_loss(centers: torch.Tensor, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean squared distance of each feature to its class center, clamped
    to [1e-12, 1e12]."""
    x = x.float()
    c = centers[labels.long()]
    sq = (torch.sum(torch.square(x), dim=1) + torch.sum(torch.square(c), dim=1)
          - 2.0 * torch.sum(x * c, dim=1))
    return torch.mean(torch.clamp(sq, 1e-12, 1e12))
