"""Adam with coupled L2 (torch's ``Adam``: weight decay added to the
gradient), per-leaf lr multipliers and decay, as CLIP-ReID's solver groups
the parameters: a bias takes ``BIAS_LR_FACTOR`` × the lr and
``WEIGHT_DECAY_BIAS``."""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def is_bias(name: str) -> bool:
    return "bias" in name.split(".")[-1]


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], solver: dict):
        self.solver = solver
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    def decay(self, name: str) -> float:
        return float(self.solver["WEIGHT_DECAY_BIAS" if is_bias(name) else "WEIGHT_DECAY"])

    def effective_grad(self, name, p, g):
        """The gradient as the update takes it: the loss's plus decay·p."""
        return g + self.decay(name) * p

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], lr: float):
        self.t += 1
        bc1, bc2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        for k, p in params.items():
            g = self.effective_grad(k, p, grads[k])
            self.m[k].mul_(B1).add_((1 - B1) * g)
            self.v[k].mul_(B2).add_((1 - B2) * g * g)
            mult = float(self.solver.get("BIAS_LR_FACTOR", 1)) if is_bias(k) else 1.0
            p.sub_(lr * mult * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + EPS))
