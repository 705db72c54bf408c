"""Baseline train and eval loops.

ref mpreid_tpu/engine/processor.py::run_validation, ::do_inference,
::do_train. ``do_train`` builds the step and the state (``SOLVER.RESUME``
included) and runs ``train_epochs``, the epoch loop it shares with the
Uni-Prompt stage 2 (``engine/uniprompt.py``): the lr of each epoch from the
schedule, the train steps, metrics drained from the device only at log
points, samples/s with the reference's definition (batch size / time per
batch), checkpoints and validation at their periods. ``run_validation``
extracts features batch by batch, then runs the evaluator. The JAX
package's eval-step cache keyed on ``id(model)`` is not carried over:
building the step is cheap in eager PyTorch. ``TPU.EVAL_SHARDED``,
``TPU.ZERO_OPT_STATE`` and ``TPU.TP_TOWERS`` act in the JAX package only over
a mesh of more than one device, so on one card they do nothing here either
(``check_tpu_keys`` logs so). Not ported: the mesh itself (the parallel
slice), the whole-epoch device-resident dataset (``TPU.DEVICE_DATASET``) and
``TPU.PROFILE_DIR`` tracing, which raise.
"""

from __future__ import annotations

import logging
import os
import time
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch

from mpreid_tpu_torch.utils.checkpoint import load_checkpoint, restore_state, save_checkpoint
from mpreid_tpu_torch.utils.meter import AverageMeter

from .evaluator import R1mAPEvaluator
from .steps import make_eval_step, make_train_step
from .train_state import initial_state

# TPU keys the JAX package acts on only over a mesh of more than one device
# (ref processor.py:69, :187; uniprompt.py:192): no-ops on one card
SINGLE_DEVICE_NOOPS = ("EVAL_SHARDED", "ZERO_OPT_STATE", "TP_TOWERS")
# the keys a training loop reads: the no-ops above and two that are not ported
TRAIN_TPU_KEYS = ("DEVICE_DATASET", "TP_TOWERS", "ZERO_OPT_STATE", "PROFILE_DIR")


def check_tpu_keys(cfg, keys, logger) -> None:
    """Log each set key of ``SINGLE_DEVICE_NOOPS`` as doing nothing on one
    device; raise for any other set key (not ported yet)."""
    for key in keys:
        if not cfg.TPU[key]:
            continue
        if key not in SINGLE_DEVICE_NOOPS:
            raise NotImplementedError(f"TPU.{key} is not ported yet (ROADMAP.md, A.4)")
        logger.info(f"TPU.{key} does nothing on one device (the JAX package acts on it "
                    "only over a mesh of more than one)")


def run_validation(cfg, model, val_loader, num_query, logger=None,
                   epoch: Optional[int] = None):
    """Shared eval loop (ref processor.py:117-158 / 187-208) → (cmc, mAP)."""
    check_tpu_keys(cfg, ("EVAL_SHARDED",), logger or logging.getLogger("mpreid_tpu_torch"))
    evaluator = R1mAPEvaluator(
        num_query,
        max_rank=50,
        feat_norm=cfg.TEST.FEAT_NORM == "yes",
        reranking=cfg.TEST.RE_RANKING,
        camera_filter=cfg.TEST.CAMERA_FILTER,
        rerank_fast=cfg.TEST.RERANK_FAST,
        rerank_sparse_n=cfg.TEST.RERANK_SPARSE_N,
        dist_metric=cfg.TEST.DIST_METRIC,
        device=next(model.parameters()).device,
    )
    eval_step = make_eval_step(model, cfg)
    for batch in val_loader.iter_sequential():
        feat = eval_step(batch)
        n = batch["count"]
        evaluator.update((feat[:n], batch["pids"][:n], batch["camids"][:n]))
    cmc, mAP, distmat, *_ = evaluator.compute()
    if cfg.TEST.DIST_MAT and cfg.OUTPUT_DIR:
        np.save(os.path.join(cfg.OUTPUT_DIR, cfg.TEST.DIST_MAT), distmat)
    if logger:
        tag = f" - Epoch: {epoch}" if epoch is not None else " "
        logger.info(f"Validation Results{tag}")
        logger.info("mAP: {:.1%}".format(mAP))
        for r in (1, 5, 10):
            if r <= len(cmc):  # tiny galleries have fewer ranks than 10
                logger.info("CMC curve, Rank-{:<3}:{:.1%}".format(r, cmc[r - 1]))
    return cmc, mAP


def do_inference(cfg, model, val_loader, num_query: int):
    """Feature extraction + metrics (ref processor.py:166-208) → (rank-1, rank-5)."""
    logger = logging.getLogger("mpreid_tpu_torch.test")
    logger.info("Enter inferencing")
    cmc, _ = run_validation(cfg, model, val_loader, num_query, logger)
    return cmc[0], cmc[4]


def train_epochs(cfg, model, train_loader, val_loader, num_query: int, train_step, state,
                 scheduler: Callable[[int], float], start_epoch: int, epochs: int,
                 log_period: int, checkpoint_period: int, eval_period: int,
                 checkpoint_path: Callable[[int], str], logger):
    """The epoch loop shared by ``do_train`` and the Uni-Prompt stage 2:
    the lr of each epoch from the schedule, the train steps, metrics drained
    from the device only at log points, samples/s with the reference's
    definition (batch size / time per batch), checkpoints (to
    ``checkpoint_path(epoch)`` when it is not empty) and validation at their
    periods → (state, history). The augmentation draws come from a
    ``torch.Generator`` on the model's device seeded with ``SOLVER.SEED``."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(cfg.SOLVER.SEED))
    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    batch_size = train_loader.batcher.batch_size
    history = []

    for epoch in range(start_epoch, epochs + 1):
        start_time = time.time()
        loss_meter.reset()
        acc_meter.reset()
        lr = scheduler(epoch)
        pending = []  # device scalars, fetched only at log points

        def drain():
            for m in pending:
                loss_meter.update(float(m["loss"]), batch_size)
                acc_meter.update(float(m["acc"]), 1)
            pending.clear()

        n_iter = -1
        for n_iter, batch in enumerate(train_loader.epoch(epoch)):
            state, metrics = train_step(state, batch, lr, gen)
            pending.append(metrics)
            if (n_iter + 1) % log_period == 0:
                drain()
                logger.info(
                    "Epoch[{}] Iteration[{}/{}] Loss: {:.3f}, Acc: {:.3f}, Base Lr: {:.2e}".format(
                        epoch, n_iter + 1, len(train_loader), loss_meter.avg,
                        acc_meter.avg, lr))
        drain()
        if n_iter < 0:
            raise RuntimeError("empty training epoch — dataset smaller than one batch")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        time_per_batch = (time.time() - start_time) / (n_iter + 1)
        logger.info("Epoch {} done. Time per batch: {:.3f}[s] Speed: {:.1f}[samples/s]".format(
            epoch, time_per_batch, batch_size / time_per_batch))
        history.append({"epoch": epoch, "loss": loss_meter.avg, "acc": acc_meter.avg})

        path = checkpoint_path(epoch)
        if path and epoch % checkpoint_period == 0:
            save_checkpoint(path, state, epoch)
        if epoch % eval_period == 0 and val_loader is not None:
            run_validation(cfg, model, val_loader, num_query, logger, epoch)
    return state, history


def do_train(cfg, model, train_loader, val_loader, optimizer,
             scheduler: Callable[[int], float], loss_fn, num_query: int,
             centers: Optional[torch.Tensor] = None, max_epochs: Optional[int] = None):
    """Baseline training loop (ref processor.py:11-164) → (state, history).

    ``train_loader.epoch(e)`` yields numpy batches."""
    solver = cfg.SOLVER
    epochs = max_epochs or solver.MAX_EPOCHS
    logger = logging.getLogger("mpreid_tpu_torch.train")
    check_tpu_keys(cfg, TRAIN_TPU_KEYS, logger)
    logger.info("start training")

    with_center = "center" in cfg.MODEL.METRIC_LOSS_TYPE
    center_weight = solver.CENTER_LOSS_WEIGHT if with_center else None
    train_step = make_train_step(model, cfg, loss_fn, optimizer, center_weight=center_weight,
                                 center_lr=solver.CENTER_LR if with_center else None)
    state = initial_state(model, optimizer, centers=centers if with_center else None)
    start_epoch = 1
    if solver.RESUME:
        start_epoch = restore_state(state, load_checkpoint(solver.RESUME)) + 1
        logger.info(f"Resumed from {solver.RESUME} at epoch {start_epoch}")

    all_start = time.monotonic()
    state, history = train_epochs(
        cfg, model, train_loader, val_loader, num_query, train_step, state, scheduler,
        start_epoch, epochs, solver.LOG_PERIOD, solver.CHECKPOINT_PERIOD, solver.EVAL_PERIOD,
        lambda e: cfg.OUTPUT_DIR and os.path.join(cfg.OUTPUT_DIR, f"{cfg.MODEL.NAME}_{e}.pth"),
        logger)
    logger.info(f"Total running time: {timedelta(seconds=time.monotonic() - all_start)}")
    return state, history
