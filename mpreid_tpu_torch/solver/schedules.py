"""Learning-rate schedules as plain epoch → lr functions.

ref mpreid_tpu/solver/schedules.py::warmup_multistep, ::warmup_cosine,
::with_lr_noise, ::make_scheduler. The reference steps its schedulers once
per epoch, so the lr is constant within an epoch; the epoch loop
evaluates the schedule on the host and hands the float to the train step.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Sequence

import numpy as np

Schedule = Callable[[int], float]


def warmup_multistep(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                     warmup_factor: float = 1.0 / 3, warmup_iters: int = 500,
                     warmup_method: str = "linear") -> Schedule:
    """WarmupMultiStepLR: linear or constant warmup over ``warmup_iters``
    epochs, then γ-step decay at each milestone."""
    milestones = list(milestones)
    if milestones != sorted(milestones):
        raise ValueError(f"Milestones should be increasing, got {milestones}")
    if warmup_method not in ("constant", "linear"):
        raise ValueError(f"Only 'constant' or 'linear' warmup accepted, got {warmup_method}")

    def schedule(epoch: int) -> float:
        factor = 1.0
        if epoch < warmup_iters:
            if warmup_method == "constant":
                factor = warmup_factor
            else:
                alpha = epoch / warmup_iters
                factor = warmup_factor * (1 - alpha) + alpha
        return base_lr * factor * gamma ** bisect.bisect_right(milestones, epoch)

    return schedule


def warmup_cosine(base_lr: float, t_initial: int, lr_min: float = 0.0, warmup_t: int = 0,
                  warmup_lr_init: float = 0.0, cycle_limit: int = 1,
                  decay_rate: float = 0.1) -> Schedule:
    """timm CosineLRScheduler (t_mul 1): linear warmup from
    ``warmup_lr_init`` over ``warmup_t`` epochs, then cosine from base to
    ``lr_min``; past the last cycle the lr stays at ``lr_min``."""
    warmup_step = (base_lr - warmup_lr_init) / warmup_t if warmup_t else 0.0

    def schedule(t: int) -> float:
        if warmup_t and t < warmup_t:
            return warmup_lr_init + t * warmup_step
        i = t // t_initial
        t_curr = t - t_initial * i
        if cycle_limit == 0 or i < cycle_limit:
            gamma = decay_rate ** i
            lo = lr_min * gamma
            hi = base_lr * gamma
            return lo + 0.5 * (hi - lo) * (1 + math.cos(math.pi * t_curr / t_initial))
        return lr_min

    return schedule


def with_lr_noise(schedule: Schedule, noise_range_t, noise_pct: float = 0.67,
                  noise_std: float = 1.0, noise_seed: int = 42) -> Schedule:
    """timm lr noise: within ``noise_range_t`` ((start, end) or a start
    epoch) the lr becomes ``lr · (1 + n)``, n ~ N(0, noise_std) redrawn
    until |n| < noise_pct, seeded with ``noise_seed + t``."""
    if noise_range_t is None:
        return schedule
    if isinstance(noise_range_t, (list, tuple)):
        lo, hi = noise_range_t
    else:
        lo, hi = noise_range_t, float("inf")

    def noisy(t: int) -> float:
        lr = schedule(t)
        if lo <= t < hi:
            rng = np.random.RandomState(noise_seed + t)
            while True:
                n = rng.randn() * noise_std
                if abs(n) < noise_pct:
                    break
            lr = lr + lr * n
        return lr

    return noisy


def make_scheduler(stage_cfg, kind: str) -> Schedule:
    """'multistep' → WarmupMultiStepLR over STEPS/GAMMA; 'cosine' → timm cosine."""
    if kind == "multistep":
        return warmup_multistep(stage_cfg.BASE_LR, stage_cfg.STEPS, stage_cfg.GAMMA,
                                stage_cfg.WARMUP_FACTOR, stage_cfg.WARMUP_ITERS,
                                stage_cfg.WARMUP_METHOD)
    if kind == "cosine":
        return warmup_cosine(stage_cfg.BASE_LR, t_initial=stage_cfg.MAX_EPOCHS,
                             lr_min=stage_cfg.LR_MIN, warmup_t=stage_cfg.WARMUP_EPOCHS,
                             warmup_lr_init=stage_cfg.WARMUP_LR_INIT)
    raise ValueError(f"Unknown scheduler kind {kind!r}")
