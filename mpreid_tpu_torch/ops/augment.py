"""Image preprocessing and training augmentation on the device.

ref mpreid_tpu/ops/augment.py::normalize, ::eval_preprocess,
::train_augment, ::_random_flip, ::_pad_crop_batch, ::_random_erase,
::MIN_ERASE_AREA, ::MAX_ERASE_AREA, ::MIN_ERASE_ASPECT.

The host has already decoded and resized. ``eval_preprocess`` is ToTensor +
Normalize over the uint8 NHWC batch. ``train_augment`` is the reference's
torchvision stack on the device:

    RandomHorizontalFlip → Pad(p) + RandomCrop → Normalize
    → RandomErasing (timm, per-pixel noise, one rectangle)

Its draws come from an explicit ``torch.Generator`` on the batch's device
(``train_augment_draws``); ``train_augment_with_draws`` applies given draws,
so a test can feed it the JAX package's. As there, the erase rectangle is
drawn once and clamped into the image instead of timm's up-to-10 retries.
The train path copies nothing from the host: its per-channel mean and std
are made on the device once (``channel_values``), so a CUDA graph can
capture it (``engine/compiled.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

MIN_ERASE_AREA = 0.02
MAX_ERASE_AREA = 1.0 / 3.0
MIN_ERASE_ASPECT = 0.3


@functools.lru_cache(maxsize=None)
def channel_values(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """``values`` as an fp32 tensor on ``device``, made at first use and
    kept."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """uint8/float (B,H,W,3) → normalized float32."""
    x = images.float() / 255.0 if images.dtype == torch.uint8 else images
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def eval_preprocess(images_u8: torch.Tensor,
                    mean: Sequence[float] = (0.485, 0.456, 0.406),
                    std: Sequence[float] = (0.229, 0.224, 0.225)) -> torch.Tensor:
    """Val/test pipeline: ToTensor + Normalize (the host already resized)."""
    return normalize(images_u8, mean, std)


def erase_rectangles(area_frac: torch.Tensor, log_ratio: torch.Tensor, y_draw: torch.Tensor,
                     x_draw: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 4) int64 rectangles (y0, x0, eh, ew) from the raw erase draws: the
    area as a fraction of the image, the log aspect ratio, and row and column
    draws in [0, h) and [0, w), clamped so the rectangle fits."""
    target_area = area_frac * h * w
    aspect = torch.exp(log_ratio)
    eh = torch.clamp(torch.round(torch.sqrt(target_area * aspect)).long(), 1, h - 1)
    ew = torch.clamp(torch.round(torch.sqrt(target_area / aspect)).long(), 1, w - 1)
    y0 = torch.minimum(y_draw.long(), h - eh)
    x0 = torch.minimum(x_draw.long(), w - ew)
    return torch.stack([y0, x0, eh, ew], dim=1)


def train_augment_draws(b: int, h: int, w: int, gen: torch.Generator, flip_prob: float = 0.5,
                        padding: int = 10, re_prob: float = 0.5) -> Dict[str, torch.Tensor]:
    """Every random draw of one ``train_augment`` call, on ``gen``'s device."""
    dev = gen.device

    def uniform(lo=0.0, hi=1.0):
        return torch.rand(b, generator=gen, device=dev) * (hi - lo) + lo

    flip = uniform() < flip_prob
    offsets = torch.randint(0, 2 * padding + 1, (b, 2), generator=gen, device=dev)
    gate = uniform() < re_prob
    rect = erase_rectangles(
        uniform(MIN_ERASE_AREA, MAX_ERASE_AREA),
        uniform(math.log(MIN_ERASE_ASPECT), math.log(1.0 / MIN_ERASE_ASPECT)),
        torch.randint(0, h, (b,), generator=gen, device=dev),
        torch.randint(0, w, (b,), generator=gen, device=dev), h, w)
    noise = torch.randn((b, h, w, 3), generator=gen, device=dev)
    return {"flip": flip, "offsets": offsets, "gate": gate, "rect": rect, "noise": noise}


def train_augment_with_draws(images_u8: torch.Tensor, flip: torch.Tensor, offsets: torch.Tensor,
                             gate: torch.Tensor, rect: torch.Tensor, noise: torch.Tensor,
                             mean: Sequence[float] = (0.485, 0.456, 0.406),
                             std: Sequence[float] = (0.229, 0.224, 0.225),
                             padding: int = 10) -> torch.Tensor:
    """(B,H,W,3) uint8 → augmented normalized float32, with the draws given:
    ``flip`` (B,) bool; ``offsets`` (B, 2) crop offsets (y, x) in
    [0, 2·padding]; ``gate`` (B,) bool, erase or not; ``rect`` (B, 4)
    (y0, x0, eh, ew); ``noise`` (B, H, W, 3) fp32 erase values."""
    b, h, w, _ = images_u8.shape
    x = images_u8.float() / 255.0
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    if padding:
        padded = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
        rows = offsets[:, 0, None] + torch.arange(h, device=x.device)  # (B, H)
        cols = offsets[:, 1, None] + torch.arange(w, device=x.device)  # (B, W)
        bidx = torch.arange(b, device=x.device)[:, None, None]
        x = padded[bidx, rows[:, :, None], cols[:, None, :]]
    x = (x - channel_values(tuple(mean), x.device)) / channel_values(tuple(std), x.device)
    y0, x0, eh, ew = (rect[:, i, None, None] for i in range(4))
    rr = torch.arange(h, device=x.device)[None, :, None]
    cc = torch.arange(w, device=x.device)[None, None, :]
    inside = (rr >= y0) & (rr < y0 + eh) & (cc >= x0) & (cc < x0 + ew) & gate[:, None, None]
    return torch.where(inside[..., None], noise, x)


def train_augment(images_u8: torch.Tensor, gen: torch.Generator,
                  mean: Sequence[float] = (0.485, 0.456, 0.406),
                  std: Sequence[float] = (0.229, 0.224, 0.225),
                  flip_prob: float = 0.5, padding: int = 10,
                  re_prob: float = 0.5, shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(B,H,W,3) uint8 → augmented normalized float32 batch; draws from ``gen``.

    With ``shard`` = (ranks, rank) the batch is this rank's block of a global
    batch of ranks·B images: the global batch's draws are made (the same on
    every rank, whose generators agree) and this rank's rows of them applied,
    so the ranks together augment exactly as one process does."""
    b, h, w, _ = images_u8.shape
    if shard is None:
        draws = train_augment_draws(b, h, w, gen, flip_prob, padding, re_prob)
    else:
        ranks, rank = shard
        draws = train_augment_draws(b * ranks, h, w, gen, flip_prob, padding, re_prob)
        draws = {k: v[rank * b:(rank + 1) * b] for k, v in draws.items()}
    return train_augment_with_draws(images_u8, mean=mean, std=std, padding=padding, **draws)
