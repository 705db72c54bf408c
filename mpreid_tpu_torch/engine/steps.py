"""Eval feature extraction step.

ref mpreid_tpu/engine/steps.py::make_eval_step. The JAX package compiles
one program per step; PyTorch runs eagerly, so the step is a closure that
moves the uint8 batch to the model's device, normalises it there and runs
``ReIDModel.forward_eval`` under ``torch.inference_mode``. Train steps
belong to the training slice.
"""

from __future__ import annotations

import torch

from mpreid_tpu_torch.ops.augment import eval_preprocess


def labels_for(cfg, batch):
    cam = batch["camids"] if cfg.MODEL.SIE_CAMERA else None
    view = batch["trackids"] if cfg.MODEL.SIE_VIEW else None
    return cam, view


def make_eval_step(model, cfg):
    """→ ``step(batch)``: numpy batch dict → features on the device."""
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    device = next(model.parameters()).device

    def to_device(a):
        return None if a is None else torch.as_tensor(a).to(device, non_blocking=True)

    @torch.inference_mode()
    def step(batch) -> torch.Tensor:
        x = eval_preprocess(to_device(batch["images"]), mean=mean, std=std)
        cam, view = labels_for(cfg, batch)
        return model.forward_eval(x, to_device(cam), to_device(view))

    return step
