"""Uni-Prompt stage loops.

ref mpreid_tpu/engine/uniprompt.py::build_image_bank, ::do_train_stage1,
::precompute_text_features, ::do_train_stage2, ::do_inference (reference
``processor/processor_uniprompt_stage{1,2}.py``).

Stage 1 (a/b): an image-feature bank is built once with the frozen encoder
and stays on the device; then only the prompt contexts train, with SupCon
i2t + t2i over shuffled bank batches. Each epoch draws its order from
``np.random.default_rng(SOLVER.SEED)`` as the JAX package does, runs the
full batches as one ``make_stage1_epoch`` call (one captured CUDA graph
replayed per batch on the card, ``engine/compiled.py``) and then the
trailing partial one through ``make_stage1_step`` (a graph of its own,
replayed from the third epoch on), so both packages' epochs see the same
batches; the views enter in 1b only. The bank and the text features run
through graphed steps too (``make_image_bank_step``, ``make_text_step``),
each released when its pass ends. The epoch's losses come
back once, at its end, and are logged at the same iterations as the JAX
package logs them. Spans (``utils/tracing.py``, under a profiler):
``stage1.epoch`` (one epoch), inside it ``stage1.fetch`` (losses fetched to
the host) and ``stage1.trailing`` (the partial batch's step and its fetch).
Stage 2 (a/b): text features of every class are computed once, then the
model fine-tunes with ID + triplet + i2t losses (and, with the MoE tower,
the load-balancing loss) under the stage's freeze policy, through the
baseline's epoch loop (``processor.train_epochs``), over the device-resident
train set with ``TPU.DEVICE_DATASET``.
The four freeze regimes are four optimizers over one model
(``solver.optim.stage_trainable``). Checkpoints are full-state ``.pth``
files: ``{NAME}_stage{1a,1b}_{epoch}.pth`` under ``OUTPUT_DIR`` and
``{NAME}_{epoch}.pth`` under ``OUTPUT_DIR/EXP_SETTING``. Stage 2 traces
nothing: the JAX package's stage 2 never reads ``TPU.PROFILE_DIR``, and
here it is logged as doing nothing.

The mesh (ref mpreid_tpu/engine/uniprompt.py:187-215): stage 2 takes the
baseline's mesh branch (``processor.data_parallel``), dense and MoE alike,
model axis included, with the text features computed on every rank before
the model is sliced; stage 1 has no mesh in the JAX package, so every rank
runs it alike, unsliced (rank 0 alone writes its checkpoints).
"""

from __future__ import annotations

import logging
import os
import time
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch

from mpreid_tpu_torch.utils.checkpoint import save_checkpoint, wait_for_pending_saves
from mpreid_tpu_torch.utils.meter import AverageMeter
from mpreid_tpu_torch.utils.tracing import span

from mpreid_tpu_torch.parallel import is_main

from .processor import (
    data_parallel, do_inference, rank_logger, release_eval_steps, start_data_parallel,
    train_epochs,
)
from .steps import (
    make_image_bank_step, make_stage1_epoch, make_stage1_step, make_text_step, make_train_epoch,
    make_train_step,
)
from .train_state import initial_state

__all__ = ["build_image_bank", "do_inference", "do_train_stage1", "do_train_stage2",
           "precompute_text_features"]

logger = logging.getLogger("mpreid_tpu_torch.train")


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def build_image_bank(cfg, model, train_loader_stage1):
    """One pass over the train set with the frozen encoder (ref stage1:41-64)
    → (features on the model's device in the compute dtype, labels, views),
    the last two numpy arrays."""
    bank_step = make_image_bank_step(model, cfg)
    feats, labels, views = [], [], []
    for batch in train_loader_stage1.epoch(0, drop_last=False):
        n = batch["count"]
        feats.append(bank_step(batch)[:n])
        labels.append(batch["pids"][:n])
        views.append(batch["trackids"][:n])
    bank_step.release()
    return torch.cat(feats), np.concatenate(labels), np.concatenate(views)


def do_train_stage1(cfg, model, train_loader_stage1, optimizer,
                    scheduler: Callable[[int], float], is_stage1b: bool = False,
                    bank=None, stage_cfg=None):
    """Prompt-context training (ref processor_uniprompt_stage1.py:11-120) →
    (state, history); the model's contexts are updated in place."""
    stage_cfg = stage_cfg or cfg.SOLVER.STAGE1
    stage = "1b" if is_stage1b else "1a"
    log = rank_logger(logger)
    log.info(f"Start training stage {stage}")
    all_start = time.monotonic()

    if bank is None:
        bank = build_image_bank(cfg, model, train_loader_stage1)
    device = _device_of(model)
    feats_bank = bank[0].to(device)
    labels_bank = torch.as_tensor(bank[1]).to(device).long()
    views_bank = torch.as_tensor(bank[2]).to(device).long()

    step = make_stage1_step(model, cfg, optimizer, stage)
    epoch_fn = make_stage1_epoch(model, cfg, optimizer, stage)
    state = initial_state(model, optimizer)
    batch = stage_cfg.IMS_PER_BATCH
    num_image = labels_bank.shape[0]
    i_ter = num_image // batch
    loss_meter = AverageMeter()
    rng = np.random.default_rng(cfg.SOLVER.SEED)
    history = []

    for epoch in range(1, stage_cfg.MAX_EPOCHS + 1):
        loss_meter.reset()
        lr = scheduler(epoch)
        perm = rng.permutation(num_image)
        with span("stage1.epoch"):
            # the full batches as one compiled epoch ...
            if i_ter > 0:
                rows = perm[:i_ter * batch].reshape(i_ter, batch)
                state, losses = epoch_fn(state, feats_bank, labels_bank, views_bank, rows, lr)
                with span("stage1.fetch"):
                    losses = losses.tolist()
                for i, loss in enumerate(losses):
                    loss_meter.update(loss, batch)
                    if (i + 1) % stage_cfg.LOG_PERIOD == 0:
                        log.info("Epoch[{}] Iteration[{}/{}] Loss: {:.3f}, Base Lr: {:.2e}".format(
                            epoch, i + 1, i_ter + 1, loss_meter.avg, lr))
            # ... and the trailing partial batch through the single step
            rest = perm[i_ter * batch:]
            if len(rest):
                with span("stage1.trailing"):
                    sel = torch.from_numpy(rest).to(device)
                    state, metrics = step(state, feats_bank[sel], labels_bank[sel],
                                          views_bank[sel] if is_stage1b else None, lr)
                    with span("stage1.fetch"):
                        loss = float(metrics["loss"])
                loss_meter.update(loss, len(rest))
        history.append({"epoch": epoch, "loss": loss_meter.avg})
        if cfg.OUTPUT_DIR and epoch % stage_cfg.CHECKPOINT_PERIOD == 0 and is_main():
            name = f"{cfg.MODEL.NAME}_stage{stage}_{epoch}.pth"
            save_checkpoint(os.path.join(cfg.OUTPUT_DIR, name), state, epoch, cfg)

    epoch_fn.release()
    step.release()
    log.info(f"Stage {stage} running time: {timedelta(seconds=time.monotonic() - all_start)}")
    wait_for_pending_saves()  # surface a failed TPU.ASYNC_CHECKPOINT write
    return state, history


def precompute_text_features(cfg, model, num_classes: int,
                             batch: Optional[int] = None) -> torch.Tensor:
    """Stage-2 text features of every class, in label batches (ref
    stage2:58-73) → (num_classes, embed_dim) on the model's device."""
    batch = batch or cfg.SOLVER.STAGE2.IMS_PER_BATCH
    text_step = make_text_step(model, stage="2")
    device = _device_of(model)
    feats = torch.cat([text_step(torch.arange(lo, min(lo + batch, num_classes), device=device))
                       for lo in range(0, num_classes, batch)])
    text_step.release()
    return feats


def do_train_stage2(cfg, model, train_loader_stage2, val_loader, optimizer,
                    scheduler: Callable[[int], float], loss_fn, num_query: int,
                    num_classes: int, centers: Optional[torch.Tensor] = None,
                    max_epochs: Optional[int] = None, log_period: Optional[int] = None,
                    checkpoint_period: Optional[int] = None, eval_period: Optional[int] = None):
    """Stage-2 fine-tune (ref processor_uniprompt_stage2.py:14-223) →
    (state, history)."""
    log = rank_logger(logger)
    if cfg.TPU.PROFILE_DIR:
        log.info("TPU.PROFILE_DIR does nothing in stage 2 (the JAX package traces only "
                    "the baseline loop)")
    s2 = cfg.SOLVER.STAGE2
    log.info("start training")
    all_start = time.monotonic()
    text_features = precompute_text_features(cfg, model, num_classes)
    mesh, optimizer = data_parallel(cfg, optimizer, log, model)
    with_center = "center" in cfg.MODEL.METRIC_LOSS_TYPE
    kwargs = dict(center_weight=s2.CENTER_LOSS_WEIGHT if with_center else None,
                  center_lr=s2.CENTER_LR if with_center else None,
                  uniprompt=True, text_features=text_features)
    train_step = make_train_step(model, cfg, loss_fn, optimizer, **kwargs, mesh=mesh)
    train_epoch = make_train_epoch(model, cfg, loss_fn, optimizer, **kwargs) \
        if cfg.TPU.DEVICE_DATASET and mesh is None else None
    state = initial_state(model, optimizer, centers=centers if with_center else None)
    if mesh is not None:
        train_loader_stage2 = start_data_parallel(state, optimizer, train_loader_stage2, mesh)
    out_dir = cfg.OUTPUT_DIR and os.path.join(cfg.OUTPUT_DIR, cfg.DATASETS.EXP_SETTING)
    state, history = train_epochs(
        cfg, model, train_loader_stage2, val_loader, num_query, train_step, state, scheduler,
        1, max_epochs or s2.MAX_EPOCHS, log_period or s2.LOG_PERIOD,
        checkpoint_period or s2.CHECKPOINT_PERIOD, eval_period or s2.EVAL_PERIOD,
        lambda e: out_dir and os.path.join(out_dir, f"{cfg.MODEL.NAME}_{e}.pth"), logger,
        train_epoch, optimizer=optimizer, mesh=mesh)
    for compiled in (train_step, train_epoch):  # before a later stage captures its own
        if compiled is not None:
            compiled.release()
    release_eval_steps(model)
    log.info(f"Total running time: {timedelta(seconds=time.monotonic() - all_start)}")
    wait_for_pending_saves()  # surface a failed TPU.ASYNC_CHECKPOINT write
    return state, history
