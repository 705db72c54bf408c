"""Baseline train and eval loops.

ref mpreid_tpu/engine/processor.py::run_validation, ::do_inference,
::do_train. ``do_train`` owns the epoch loop: the lr of each epoch from the
schedule, the train steps, metrics drained from the device only at log
points, samples/s with the reference's definition (batch size / time per
batch), checkpoints and validation at their periods, and ``SOLVER.RESUME``.
``run_validation`` extracts features batch by batch, then runs the
evaluator. The JAX package's eval-step cache keyed on ``id(model)`` is not
carried over: building the step is cheap in eager PyTorch. Not ported here:
gallery-sharded eval (``TPU.EVAL_SHARDED``), the mesh, ZeRO and TP branches
of ``do_train`` (the parallel slice), the whole-epoch device-resident
dataset (``TPU.DEVICE_DATASET``) and ``TPU.PROFILE_DIR`` tracing.
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


def run_validation(cfg, model, val_loader, num_query, logger=None,
                   epoch: Optional[int] = None):
    """Shared eval loop (ref processor.py:117-158 / 187-208) → (cmc, mAP)."""
    if cfg.TPU.EVAL_SHARDED:
        raise NotImplementedError(
            "TPU.EVAL_SHARDED is not ported yet (ROADMAP.md, A11 parallel modes)"
        )
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


def do_train(cfg, model, train_loader, val_loader, optimizer,
             scheduler: Callable[[int], float], loss_fn, num_query: int,
             centers: Optional[torch.Tensor] = None, max_epochs: Optional[int] = None):
    """Baseline training loop (ref processor.py:11-164) → (state, history).

    ``train_loader.epoch(e)`` yields numpy batches; the augmentation draws
    come from a ``torch.Generator`` on the model's device seeded with
    ``SOLVER.SEED``."""
    solver = cfg.SOLVER
    epochs = max_epochs or solver.MAX_EPOCHS
    for key in ("DEVICE_DATASET", "TP_TOWERS", "ZERO_OPT_STATE", "PROFILE_DIR"):
        if cfg.TPU[key]:
            raise NotImplementedError(f"TPU.{key} is not ported yet (ROADMAP.md)")
    logger = logging.getLogger("mpreid_tpu_torch.train")
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

    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(solver.SEED))
    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    batch_size = train_loader.batcher.batch_size
    all_start = time.monotonic()
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
            if (n_iter + 1) % solver.LOG_PERIOD == 0:
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

        if cfg.OUTPUT_DIR and epoch % solver.CHECKPOINT_PERIOD == 0:
            save_checkpoint(os.path.join(cfg.OUTPUT_DIR, f"{cfg.MODEL.NAME}_{epoch}.pth"),
                            state, epoch)
        if epoch % solver.EVAL_PERIOD == 0 and val_loader is not None:
            run_validation(cfg, model, val_loader, num_query, logger, epoch)

    logger.info(f"Total running time: {timedelta(seconds=time.monotonic() - all_start)}")
    return state, history
