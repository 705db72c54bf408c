"""The training augmentation of CLIP-ReID's recipe: horizontal flip
(p 0.5), pad 10 and crop back at a random offset, normalise, random erasing
(p 0.5) of one rectangle of 0.02–1/3 of the area, aspect ratio 0.3–3.33,
filled with normal noise.

The draws come from the same generator and seed the benchmark gives the
port, made in the order the port makes them, so both sides augment a batch
alike: one uniform per image for the flip; two crop offsets in [0, 20]; one
uniform for the erase gate; the erase area, the log aspect ratio, a row and
a column; the noise. The rectangle is drawn once and clamped into the
image."""

from __future__ import annotations

import math

import torch


def draws(b: int, h: int, w: int, gen: torch.Generator, padding: int = 10):
    dev = gen.device

    def uniform(lo, hi):
        return torch.rand(b, generator=gen, device=dev) * (hi - lo) + lo

    flip = uniform(0.0, 1.0)
    offsets = torch.randint(0, 2 * padding + 1, (b, 2), generator=gen, device=dev)
    gate = uniform(0.0, 1.0)
    area = uniform(0.02, 1.0 / 3.0)
    log_ratio = uniform(math.log(0.3), math.log(1.0 / 0.3))
    row = torch.randint(0, h, (b,), generator=gen, device=dev)
    col = torch.randint(0, w, (b,), generator=gen, device=dev)
    noise = torch.randn((b, h, w, 3), generator=gen, device=dev)
    return flip, offsets, gate, area, log_ratio, row, col, noise


def augment(images_u8, gen: torch.Generator, mean, std, flip_prob=0.5, re_prob=0.5,
            padding: int = 10):
    """uint8 (B, H, W, 3) → the augmented, normalised fp32 batch."""
    b, h, w, _ = images_u8.shape
    flip, offsets, gate, area, log_ratio, row, col, noise = draws(b, h, w, gen, padding)
    x = images_u8.float() / 255.0
    mean = torch.tensor(mean, device=x.device)
    std = torch.tensor(std, device=x.device)
    target = area * h * w  # in fp32, as the draws are
    ratio = torch.exp(log_ratio)
    eh = torch.clamp(torch.round(torch.sqrt(target * ratio)).long(), 1, h - 1)
    ew = torch.clamp(torch.round(torch.sqrt(target / ratio)).long(), 1, w - 1)
    out = torch.empty_like(x)
    for i in range(b):
        img = x[i].flip(1) if flip[i] < flip_prob else x[i]
        padded = torch.zeros((h + 2 * padding, w + 2 * padding, 3), device=x.device)
        padded[padding:padding + h, padding:padding + w] = img
        y0, x0 = int(offsets[i, 0]), int(offsets[i, 1])
        img = (padded[y0:y0 + h, x0:x0 + w] - mean) / std
        if gate[i] < re_prob:
            rh, rw = int(eh[i]), int(ew[i])
            ys, xs = min(int(row[i]), h - rh), min(int(col[i]), w - rw)
            img = img.clone()
            img[ys:ys + rh, xs:xs + rw] = noise[i, ys:ys + rh, xs:xs + rw]
        out[i] = img
    return out


def normalise(images_u8, mean, std):
    x = images_u8.float() / 255.0
    return (x - torch.tensor(mean, device=x.device)) / torch.tensor(std, device=x.device)
