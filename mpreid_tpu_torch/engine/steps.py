"""Train and eval steps.

ref mpreid_tpu/engine/steps.py::make_train_step, ::_train_step_impl,
::make_eval_step. The JAX package compiles one program per step; PyTorch
runs eagerly, so each step is a closure. The train step moves the uint8
batch to the model's device, augments it there (``ops/augment.py``), runs
``ReIDModel.forward_train``, takes the loss and its gradients with respect
to the trainable parameters only, and lets the optimizer update them in
place. Loss and accuracy come back as device tensors: nothing in the step
waits for the device. The whole-epoch scan of ``TPU.DEVICE_DATASET``
(``make_train_epoch``) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from mpreid_tpu_torch.losses import center_loss
from mpreid_tpu_torch.ops.augment import eval_preprocess, train_augment
from mpreid_tpu_torch.solver.optim import CenterOptimizer

from .train_state import TrainState


def labels_for(cfg, batch):
    cam = batch["camids"] if cfg.MODEL.SIE_CAMERA else None
    view = batch["trackids"] if cfg.MODEL.SIE_VIEW else None
    return cam, view


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def _to(device, a):
    return None if a is None else torch.as_tensor(a).to(device, non_blocking=True)


def augment_args(cfg) -> dict:
    return dict(mean=tuple(cfg.INPUT.PIXEL_MEAN), std=tuple(cfg.INPUT.PIXEL_STD),
                flip_prob=cfg.INPUT.PROB, padding=cfg.INPUT.PADDING, re_prob=cfg.INPUT.RE_PROB)


def loss_and_grads(model, cfg, loss_fn: Callable, optimizer, x: torch.Tensor,
                   target: torch.Tensor, cam=None, view=None,
                   centers: Optional[torch.Tensor] = None,
                   center_weight: Optional[float] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor],
                              Optional[torch.Tensor]]:
    """Loss, accuracy, ``{name: gradient}`` over the trainable parameters and
    the centers' gradient (ref ``_train_step_impl``'s ``inner``). The forward
    runs the BNNecks in train mode, so it updates their running statistics."""
    train, _ = optimizer.partition(model)
    with torch.enable_grad():
        out = model.forward_train(x, target, cam, view)
        loss = loss_fn(out["scores"], out["feats"], target, cam)
        inputs = list(train.values())
        if center_weight is not None:
            centers = centers.detach().requires_grad_(True)
            loss = loss + center_weight * center_loss(centers, out["feats"][1], target)
            inputs.append(centers)
        grads = torch.autograd.grad(loss, inputs)
    acc = (out["scores"][0].detach().argmax(dim=-1) == target).float().mean()
    named = dict(zip(train, grads))
    cgrad = grads[-1] if center_weight is not None else None
    return loss.detach(), acc, named, cgrad


def make_train_step(model, cfg, loss_fn: Callable, optimizer,
                    center_weight: Optional[float] = None,
                    center_lr: Optional[float] = None):
    """Baseline train step (ref processor.py:57-88 hot loop) →
    ``step(state, batch, lr, gen) → (state, {"loss", "acc"})``.

    ``batch`` holds uint8 ``images`` (B, H, W, 3) and int ``pids``,
    ``camids``, ``trackids``, as numpy arrays or tensors; ``gen`` is a
    ``torch.Generator`` on the model's device that draws the augmentation.
    With ``center_weight`` the center loss joins, and the centers take an
    SGD step on their gradient rescaled by 1/``center_weight``."""
    aug = augment_args(cfg)
    device = _device_of(model)
    center_opt = CenterOptimizer(center_lr, center_weight) if center_weight is not None else None

    def step(state: TrainState, batch, lr: float, gen: torch.Generator):
        x = train_augment(_to(device, batch["images"]), gen, **aug)
        target = _to(device, batch["pids"]).long()
        cam, view = (_to(device, a) for a in labels_for(cfg, batch))
        loss, acc, grads, cgrad = loss_and_grads(
            state.model, cfg, loss_fn, optimizer, x, target, cam, view,
            state.centers, center_weight)
        if center_opt is not None:
            state.centers = center_opt.update(cgrad, state.centers).detach()
        train, _ = optimizer.partition(state.model)
        state.opt_state = optimizer.update(grads, state.opt_state, train, lr)
        return state, {"loss": loss, "acc": acc}

    return step


def make_eval_step(model, cfg):
    """→ ``step(batch)``: numpy batch dict → features on the device."""
    mean, std = tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD)
    device = _device_of(model)

    @torch.inference_mode()
    def step(batch) -> torch.Tensor:
        x = eval_preprocess(_to(device, batch["images"]), mean=mean, std=std)
        cam, view = labels_for(cfg, batch)
        return model.forward_eval(x, _to(device, cam), _to(device, view))

    return step
