"""Eval-time image preprocessing on the device.

ref mpreid_tpu/ops/augment.py::eval_preprocess. The host has already
decoded and resized; this is ToTensor + Normalize over the uint8 NHWC batch.
Training augmentation belongs to the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch


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
