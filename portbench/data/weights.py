"""Seeded weights, made on the device in one draw.

Every parameter is ``mean + std · z`` with ``z`` a slice of one standard
normal draw over all parameters in name order, on the device, from a
``torch.Generator`` there: the same seed and the same names and shapes give
the same bits. ``rule`` sets mean and std from the name and shape (the
scales CLIP's initialisation uses; LayerNorm and BatchNorm scales 1)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    last = name.split(".")[-1]
    if "bias" in last:
        return 0.0, 0.01
    if last == "weight" and len(shape) == 1:  # LayerNorm, BatchNorm, BNNeck scales
        return 1.0, 0.0
    if "classifier" in name:
        return 0.0, 0.001
    if last == "positional_embedding" and name.startswith("text_encoder"):
        return 0.0, 0.01
    if last in ("token_embedding", "ctx_generic", "ctx_modality", "ctx_platform",
                "visual_prompt") or name.endswith("token_embedding.weight"):
        return 0.0, 0.02
    if last in ("class_embedding", "positional_embedding"):  # (width,), (L, width)
        return 0.0, shape[-1] ** -0.5
    if last in ("proj", "text_projection"):  # (width, out)
        return 0.0, shape[0] ** -0.5
    if len(shape) == 4:  # conv (out, in, k, k)
        return 0.0, math.prod(shape[1:]) ** -0.5
    if len(shape) == 2:  # (out, in)
        return 0.0, shape[1] ** -0.5
    return 0.0, 0.02


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} for ``shapes``, on ``device``."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for n in names:
        size = math.prod(shapes[n])
        mean, std = rule(n, tuple(shapes[n]))
        out[n] = (z[at:at + size].view(shapes[n]) * std + mean) if std else \
            torch.full(shapes[n], mean, device=device)
        at += size
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


@torch.no_grad()
def fill(module: torch.nn.Module, seed: int) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of ``module`` set from ``make`` → the shapes used."""
    params = dict(module.named_parameters())
    shapes = shapes_of(module)
    device = next(iter(params.values())).device
    for n, t in make(shapes, seed, device).items():
        params[n].copy_(t)
    return shapes
