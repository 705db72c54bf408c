"""Baseline train and eval loops.

ref mpreid_tpu/engine/processor.py::run_validation, ::do_inference,
::build_device_dataset, ::epoch_perm, ::do_train. ``do_train`` builds the
step and the state (``SOLVER.RESUME`` included) and runs ``train_epochs``,
the epoch loop it shares with the Uni-Prompt stage 2
(``engine/uniprompt.py``): the lr of each epoch from the schedule, the train
steps, metrics drained from the device only at log points, samples/s with
the reference's definition (batch size / time per batch), checkpoints and
validation at their periods. ``run_validation`` extracts features batch by
batch, then runs the evaluator. Its eval step is kept across validations,
as the JAX package's ``_EVAL_STEP_CACHE`` keeps its jitted one
(``cached_eval_step``): on the card the validation every ``EVAL_PERIOD``
epochs replays the graph captured at the first one, and a model whose
storage changed is captured again. The cache is held weakly on the model
(a freed model takes its steps with it, so its reused ``id`` cannot hit),
and ``do_train``, the Uni-Prompt stage 2 and the test entry points release
it when they end (``release_eval_steps``). The same cache keeps the TTA /
TTPT steps of ``engine/ttpt.py`` (``cached_step``). The train step of the
step loop is one ``steps.make_train_step`` a run: on the card its third step
captures a CUDA graph and every later one replays it
(``engine/compiled.py``); ``do_train`` releases it at the end.

``TPU.DEVICE_DATASET``: every train record is decoded once and the uint8
images and labels live on the model's device (``build_device_dataset``);
each epoch is one ``steps.make_train_epoch`` call over ``epoch_perm``'s
index matrix, with no upload or host decode inside it: on the card its
step is captured once into a CUDA graph and replayed for every batch
(``engine/compiled.py``), and the graph is released when the loop ends.
``TPU.PROFILE_DIR``
writes a ``torch.profiler`` trace (CPU activity, and CUDA's on the card) of
steps 1..``TPU.PROFILE_STEPS`` of epoch 1, or with ``DEVICE_DATASET`` of
the whole second epoch, into that directory. On the card the step loop's
trace holds step 1 eager (the second warm-up step), step 2's capture and
first replay, and replays after it. The trace carries the port's spans
(``utils/tracing.py``) as host ranges: ``train.epoch`` (the
device epoch's call; in the step loop only when a profiler is on from the
epoch's start), ``train.fetch`` (the losses' ``.tolist()``, ``drain``),
``validation.pass`` and those of the layers below (``steps.*``,
``compiled.*``, ``evaluator.*``, ``loader.batch``).

The mesh (ref processor.py:186-201, :69-100): under a process group of
more than one rank (``parallel.init_distributed``, torchrun) and
``TPU.MESH_DATA`` other than 1, ``do_train`` builds the ``('data',
'model')`` mesh of ``TPU.MESH_DATA`` × ``TPU.MESH_MODEL``. With a model
axis above 1 it slices the model over it (``parallel.shard_module``: the
classifiers, the MoE experts, ``ctx_generic`` and, under
``TPU.TP_TOWERS``, the towers' Megatron pairs). Each data group's ranks
feed their blocks of every global batch (``data/loader.py::ShardedLoader``,
by data index), the step runs from rank 0's broadcast state, and under
``TPU.ZERO_OPT_STATE`` the replicated leaves' moments are sharded over the
data axis (``parallel/zero.py``). ``TPU.DEVICE_DATASET`` is off there, as
in the JAX package. Rank 0 alone logs metrics and writes checkpoints,
whole: a ZeRO run's moments and the model axis's slices are gathered first
(every rank takes part), and ``SOLVER.RESUME`` slices them again, so a
checkpoint moves between meshes and one process. ``run_validation``
extracts the features on every rank; under ``TPU.EVAL_SHARDED`` without
``TEST.RE_RANKING`` each rank of a data group then takes one block of the
gallery and ``parallel.sharded_cmc_map`` computes the metrics. On one rank
``TPU.EVAL_SHARDED``, ``TPU.ZERO_OPT_STATE`` and ``TPU.TP_TOWERS`` do
nothing, as in the JAX package (``check_tpu_keys`` logs so), and so does
``TPU.TP_TOWERS`` with a model axis of 1.

``TPU.ASYNC_CHECKPOINT`` writes each checkpoint on a background thread
(``utils/checkpoint.py``); ``do_train`` joins the last write before it
returns. ``TPU.COMPILE_CACHE_DIR`` means nothing here: the entry points
log it (``log_inert_keys``). ``DATALOADER.NATIVE_DECODE`` chooses the
loader's decoder (``data/loader.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import weakref
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch

from mpreid_tpu_torch.data.loader import ShardedLoader
from mpreid_tpu_torch.parallel import (
    ZeroOptimizer, full_state_dict, gather_whole, is_main, make_mesh, mesh_from_cfg, rank,
    replicated, shard_module, sharded_cmc_map, sharded_params, world_size, zero_sharded,
)
from mpreid_tpu_torch.utils.checkpoint import (
    load_checkpoint, restore_state, save_checkpoint, wait_for_pending_saves,
)
from mpreid_tpu_torch.utils.meter import AverageMeter
from mpreid_tpu_torch.utils.tracing import span

from .evaluator import R1mAPEvaluator
from .steps import make_eval_step, make_train_epoch, make_train_step
from .train_state import initial_state

# TPU keys the JAX package acts on only over a mesh of more than one device
# (ref processor.py:69, :187; uniprompt.py:192), so no-ops on one card: the
# ones a training loop reads (run_validation reads EVAL_SHARDED)
TRAIN_TPU_KEYS = ("TP_TOWERS", "ZERO_OPT_STATE")
TRACE_FILE = "trace.json"  # the profiler trace's name in TPU.PROFILE_DIR

# Keys the JAX package acts on that mean nothing in the port: (node, key,
# default, why). Each logs once, at the entry points, when set to another
# value than its default (``log_inert_keys``).
INERT_KEYS = (
    ("TPU", "COMPILE_CACHE_DIR", "",
     "it is XLA's compile cache; the port's kernels build into mpreid_tpu_torch/kernels/_build/"),
)


# the eval steps kept across validations (ref processor.py::_EVAL_STEP_CACHE)
# and the TTA / TTPT steps kept across evaluations (ref ttpt.py's lru_caches):
# {model: {key: step}}, held weakly on the model
_EVAL_STEPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def eval_key(cfg) -> tuple:
    """What an eval step's program depends on beyond the model (ref
    ``_cached_eval_step``'s key): the compute dtype, the pixel mean and std
    and the SIE switches."""
    return (cfg.TPU.COMPUTE_DTYPE, tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD),
            cfg.MODEL.SIE_CAMERA, cfg.MODEL.SIE_VIEW)


def cached_step(model, key: tuple, make: Callable):
    """The step ``make()`` made at the first call with ``key`` and kept on
    ``model`` until ``release_eval_steps``; ``make`` must hold the model
    weakly (``steps.model_step(..., weak=True)``), so the cache keeps no
    model alive."""
    steps = _EVAL_STEPS.setdefault(model, {})
    if key not in steps:
        steps[key] = make()
    return steps[key]


def cached_eval_step(model, cfg, feat_norm: bool = False):
    """The eval step of ``model`` under ``cfg`` (``feat_norm``: the L2 norm
    fused, ref ``ttpt.py::_eval_feature_step_cached(model, feat_norm)``),
    kept on the model."""
    return cached_step(model, ("eval", *eval_key(cfg), feat_norm),
                       lambda: make_eval_step(model, cfg, weak=True, feat_norm=feat_norm))


def release_eval_steps(model) -> None:
    """Free the graphs of ``model``'s cached steps (eval, TTA and TTPT) and
    forget them."""
    for step in _EVAL_STEPS.pop(model, {}).values():
        step.release()


def check_tpu_keys(cfg, keys, logger) -> None:
    """Log each set key of ``keys`` (mesh keys) as doing nothing on one device."""
    for key in keys:
        if cfg.TPU[key]:
            logger.info(f"TPU.{key} does nothing on one device (the JAX package acts on it "
                        "only over a mesh of more than one)")


def log_inert_keys(cfg, logger) -> None:
    """Log each key of ``INERT_KEYS`` that ``cfg`` sets as doing nothing."""
    for node, key, default, why in INERT_KEYS:
        if cfg[node][key] != default:
            logger.info(f"{node}.{key} does nothing in the port: {why}")


def rank_logger(logger: logging.Logger) -> logging.Logger:
    """``logger`` on rank 0; on the other ranks a child of it that passes
    warnings and errors only, so one rank logs the metrics."""
    if is_main():
        return logger
    quiet = logging.getLogger(f"{logger.name}.rank{rank()}")
    quiet.setLevel(logging.WARNING)
    return quiet


def data_parallel(cfg, optimizer, logger, model):
    """(mesh, optimizer) of a training loop (ref processor.py:186-201): over
    a group of more than one rank with ``TPU.MESH_DATA`` other than 1, the
    mesh and, under ``TPU.ZERO_OPT_STATE``, the ZeRO-1 optimizer; else
    (None, ``optimizer``), the mesh keys logged as doing nothing. With a
    model axis ``model`` is first made equal on every rank (rank 0's) and
    then sliced over it (``shard_module``): build the state after this."""
    if world_size() == 1 or cfg.TPU.MESH_DATA == 1:
        check_tpu_keys(cfg, TRAIN_TPU_KEYS, logger)
        return None, optimizer
    mesh = mesh_from_cfg(cfg)
    tp_towers = bool(cfg.TPU.TP_TOWERS) and mesh.model > 1
    logger.info(f"Training over mesh {mesh.shape}"
                + (" with tensor-parallel towers" if tp_towers else "")
                + ": each data group's ranks feed their blocks of every global batch")
    if cfg.TPU.TP_TOWERS and mesh.model == 1:
        logger.info("TPU.TP_TOWERS does nothing with a model axis of 1")
    if mesh.model > 1:
        replicated(model)
        shard_module(model, mesh, tp_towers)
    if cfg.TPU.ZERO_OPT_STATE:
        optimizer = zero_sharded(optimizer, mesh, model, tp_towers=tp_towers)
        logger.info("ZeRO-1: optimizer moments sharded over 'data'")
    if cfg.TPU.DEVICE_DATASET:
        logger.info("TPU.DEVICE_DATASET is off under data parallelism (as in the JAX package)")
    return mesh, optimizer


def start_data_parallel(state, optimizer, train_loader, mesh):
    """Rank 0's model, replicated moments and centers on every rank (ZeRO's
    moment slices are each rank's own) → this rank's view of the loader."""
    zero = isinstance(optimizer, ZeroOptimizer)
    replicated(state.model, None if zero else state.opt_state, state.centers, mesh)
    return ShardedLoader(train_loader, mesh.data, mesh.rank)


def checkpoint_state(state, optimizer):
    """``state`` with the optimizer moments at the whole parameters' shapes
    and the model's whole state dict as ``model_state``: a ZeRO optimizer
    gathers its slices over the data axis, and a model sliced over a model
    axis its own (``full_state_dict``, ``gather_whole``): every rank must
    call this."""
    if isinstance(optimizer, ZeroOptimizer):
        state = dataclasses.replace(state, opt_state=optimizer.gathered(state.opt_state,
                                                                        state.model))
    opt = state.opt_state
    opt = opt._replace(mu=gather_whole(opt.mu, state.model),
                       nu=gather_whole(opt.nu, state.model))
    whole = full_state_dict(state.model) if sharded_params(state.model) else None
    return dataclasses.replace(state, opt_state=opt, model_state=whole)


def build_device_dataset(train_loader, device: torch.device):
    """Every train record decoded once, stacked, on ``device``: (uint8
    images (N, H, W, 3), int32 pids, camids, trackids) (ref
    ``build_device_dataset``)."""
    records = train_loader.batcher.records
    images = torch.from_numpy(np.stack(train_loader.batcher.decode_records(records)))

    def labels(i):
        return torch.tensor([r[i] for r in records], dtype=torch.int32, device=device)

    return images.to(device), labels(1), labels(2), labels(3)


def epoch_perm(train_loader, epoch: int, seed: int) -> np.ndarray:
    """(n_batches, batch) index matrix of one epoch, full batches only (ref
    ``epoch_perm``): the PK sampler's order, or without a sampler the
    ``default_rng(seed + epoch)`` permutation. The batch count is epoch 0's
    in every epoch: a short epoch wraps around, a long one is truncated."""
    batcher = train_loader.batcher
    bs = batcher.batch_size
    if hasattr(train_loader, "sampler"):
        idxs = np.asarray(train_loader.sampler.epoch_indices(epoch))
        n0 = len(train_loader.sampler.epoch_indices(0))
    else:
        rng = np.random.default_rng(seed + epoch)
        idxs = rng.permutation(len(batcher.records))
        n0 = len(idxs)
    n_fixed = n0 - n0 % bs
    if len(idxs) < n_fixed and len(idxs):
        idxs = np.tile(idxs, -(-n_fixed // len(idxs)))
    return idxs[:n_fixed].reshape(-1, bs)


def start_trace(device: torch.device):
    """A started ``torch.profiler`` profile: CPU activity, and CUDA's on the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, directory: str, logger) -> None:
    """Stop ``prof`` (which waits for the device) and write its Chrome trace
    to ``directory``/``TRACE_FILE``."""
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, TRACE_FILE)
    prof.export_chrome_trace(path)
    logger.info(f"Wrote profiler trace to {path}")


def run_validation(cfg, model, val_loader, num_query, logger=None,
                   epoch: Optional[int] = None, mesh=None):
    """Shared eval loop (ref processor.py:117-158 / 187-208) → (cmc, mAP).
    Under ``TPU.EVAL_SHARDED`` over more than one rank, without
    ``TEST.RE_RANKING``, the metrics come from ``sharded_gallery_metrics``
    over the data group of ``mesh`` (the training mesh; none with a data
    axis of 1) or, without one, over every rank. One pass is the span
    ``validation.pass``."""
    with span("validation.pass"):
        return _validation(cfg, model, val_loader, num_query, logger, epoch, mesh)


def _validation(cfg, model, val_loader, num_query, logger, epoch, mesh):
    sharded = (cfg.TPU.EVAL_SHARDED and world_size() > 1 and not cfg.TEST.RE_RANKING
               and (mesh is None or mesh.data > 1))
    logger = rank_logger(logger) if logger else None
    if world_size() == 1:
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
    eval_step = cached_eval_step(model, cfg)
    for batch in val_loader.iter_sequential():
        feat = eval_step(batch)
        n = batch["count"]
        evaluator.update((feat[:n], batch["pids"][:n], batch["camids"][:n]))
    if sharded:
        cmc, mAP, distmat = (*sharded_gallery_metrics(evaluator, mesh), None)
    else:
        cmc, mAP, distmat, *_ = evaluator.compute()
    if cfg.TEST.DIST_MAT and cfg.OUTPUT_DIR and distmat is not None and is_main():
        np.save(os.path.join(cfg.OUTPUT_DIR, cfg.TEST.DIST_MAT), distmat)
    if logger:
        tag = f" - Epoch: {epoch}" if epoch is not None else " "
        logger.info(f"Validation Results{tag}")
        logger.info("mAP: {:.1%}".format(mAP))
        for r in (1, 5, 10):
            if r <= len(cmc):  # tiny galleries have fewer ranks than 10
                logger.info("CMC curve, Rank-{:<3}:{:.1%}".format(r, cmc[r - 1]))
    return cmc, mAP


def sharded_gallery_metrics(evaluator: R1mAPEvaluator, mesh=None):
    """(cmc, mAP) of the evaluator's features with the gallery split over
    the ranks of ``mesh``'s data group (every rank without one; ref
    processor.py:69-100): every rank holds every feature; the
    gallery, padded to a multiple of the ranks with far-away dummies (pid
    −1, features 1e6: ranked last and never relevant, so the metrics are
    exact), is cut into one contiguous block per rank for
    ``parallel.sharded_cmc_map``; the (Q, G) distances are never formed."""
    feats = torch.cat(evaluator.feats, dim=0).float()
    pids = np.concatenate(evaluator.pids)
    camids = np.concatenate(evaluator.camids)
    if evaluator.feat_norm:
        feats = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
    nq, device = evaluator.num_query, feats.device
    mesh = mesh or make_mesh(data=world_size(), model=1)
    gf, g_pids, g_camids = feats[nq:], pids[nq:], camids[nq:]
    pad = (-len(g_pids)) % mesh.data
    if pad:
        gf = torch.cat([gf, torch.full((pad, gf.shape[1]), 1e6, device=device)])
        g_pids = np.concatenate([g_pids, np.full(pad, -1, g_pids.dtype)])
        g_camids = np.concatenate([g_camids, np.full(pad, -1, g_camids.dtype)])
    per = len(g_pids) // mesh.data
    block = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    cmc, mAP = sharded_cmc_map(feats[:nq], gf[block], dev(pids[:nq]), dev(g_pids[block]),
                               dev(camids[:nq]), dev(g_camids[block]), mesh,
                               max_rank=evaluator.max_rank, camera_filter=evaluator.camera_filter)
    return cmc.cpu().numpy(), float(mAP)


def do_inference(cfg, model, val_loader, num_query: int):
    """Feature extraction + metrics (ref processor.py:166-208) → (rank-1, rank-5)."""
    logger = logging.getLogger("mpreid_tpu_torch.test")
    logger.info("Enter inferencing")
    cmc, _ = run_validation(cfg, model, val_loader, num_query, logger)
    return cmc[0], cmc[4]


def train_epochs(cfg, model, train_loader, val_loader, num_query: int, train_step, state,
                 scheduler: Callable[[int], float], start_epoch: int, epochs: int,
                 log_period: int, checkpoint_period: int, eval_period: int,
                 checkpoint_path: Callable[[int], str], logger, train_epoch=None,
                 profile_dir: str = "", optimizer=None, mesh=None):
    """The epoch loop shared by ``do_train`` and the Uni-Prompt stage 2:
    the lr of each epoch from the schedule, the train steps, metrics drained
    from the device only at log points, samples/s with the reference's
    definition (batch size / time per batch), checkpoints (to
    ``checkpoint_path(epoch)`` when it is not empty) and validation at their
    periods → (state, history). The augmentation draws come from a
    ``torch.Generator`` on the model's device seeded with ``SOLVER.SEED``.

    With ``train_epoch`` (``steps.make_train_epoch``) the train set is
    placed on the model's device once and each epoch is one call of it over
    ``epoch_perm``'s batches; the loss and accuracy come back once, at the
    epoch's end. ``profile_dir`` traces steps 1..``TPU.PROFILE_STEPS`` of
    epoch 1, or with ``train_epoch`` the whole second epoch.

    With ``mesh`` (data parallel) ``train_loader`` yields this rank's blocks,
    every rank seeds the one generator alike, the rates count the global
    batch, rank 0 alone logs and writes the checkpoints, and ``optimizer``
    (a ZeRO one) gathers the moments for them on every rank."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(cfg.SOLVER.SEED))
    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    batch_size = train_loader.batcher.batch_size * (mesh.data if mesh is not None else 1)
    logger = rank_logger(logger)
    history = []
    data = None
    if train_epoch is not None:
        data = build_device_dataset(train_loader, device)
        logger.info(f"Device-resident dataset: {data[0].shape[0]} images, "
                    f"{sum(t.nbytes for t in data)} bytes on {device}")

    for epoch in range(start_epoch, epochs + 1):
        start_time = time.time()
        loss_meter.reset()
        acc_meter.reset()
        lr = scheduler(epoch)

        if data is not None:
            perm = epoch_perm(train_loader, epoch, cfg.SOLVER.SEED)
            if not len(perm):
                raise RuntimeError("empty training epoch — dataset smaller than one batch")
            # the second epoch: the first carries the warm-up
            prof = start_trace(device) if profile_dir and epoch == start_epoch + 1 else None
            with span("train.epoch"):
                state, (losses, accs) = train_epoch(state, *data, perm, lr, gen)
            if prof is not None:
                stop_trace(prof, profile_dir, logger)
            with span("train.fetch"):
                for loss, acc in zip(losses.tolist(), accs.tolist()):
                    loss_meter.update(loss, batch_size)
                    acc_meter.update(acc, 1)
            n_batches = len(perm)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            time_per_batch = (time.time() - start_time) / max(n_batches, 1)
            logger.info(
                "Epoch {} done. Loss: {:.3f}, Acc: {:.3f}, Time per batch: {:.3f}[s] "
                "Speed: {:.1f}[samples/s]".format(epoch, loss_meter.avg, acc_meter.avg,
                                                   time_per_batch, batch_size / time_per_batch))
        else:
            pending = []  # device scalars, fetched only at log points

            def drain():
                with span("train.fetch"):
                    for m in pending:
                        loss_meter.update(float(m["loss"]), batch_size)
                        acc_meter.update(float(m["acc"]), 1)
                    pending.clear()

            n_iter = -1
            prof = None
            with span("train.epoch"):  # recorded when a profiler is on from the epoch's start
                for n_iter, batch in enumerate(train_loader.epoch(epoch)):
                    if profile_dir and epoch == 1 and n_iter == 1:
                        prof = start_trace(device)
                    state, metrics = train_step(state, batch, lr, gen)
                    pending.append(metrics)
                    if prof is not None and n_iter == cfg.TPU.PROFILE_STEPS:
                        stop_trace(prof, profile_dir, logger)
                        prof = None
                    if (n_iter + 1) % log_period == 0:
                        drain()
                        logger.info(
                            "Epoch[{}] Iteration[{}/{}] Loss: {:.3f}, Acc: {:.3f}, Base Lr: {:.2e}"
                            .format(epoch, n_iter + 1, len(train_loader), loss_meter.avg,
                                    acc_meter.avg, lr))
                if prof is not None:  # the epoch ended inside the traced steps
                    stop_trace(prof, profile_dir, logger)
                drain()
            if n_iter < 0:
                raise RuntimeError("empty training epoch — dataset smaller than one batch")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            time_per_batch = (time.time() - start_time) / (n_iter + 1)
            logger.info("Epoch {} done. Time per batch: {:.3f}[s] Speed: {:.1f}[samples/s]"
                        .format(epoch, time_per_batch, batch_size / time_per_batch))
        history.append({"epoch": epoch, "loss": loss_meter.avg, "acc": acc_meter.avg})

        path = checkpoint_path(epoch)
        if path and epoch % checkpoint_period == 0:
            saved = checkpoint_state(state, optimizer)
            if is_main():
                save_checkpoint(path, saved, epoch, cfg)
        if epoch % eval_period == 0 and val_loader is not None:
            run_validation(cfg, model, val_loader, num_query, logger, epoch, mesh=mesh)
    return state, history


def do_train(cfg, model, train_loader, val_loader, optimizer,
             scheduler: Callable[[int], float], loss_fn, num_query: int,
             centers: Optional[torch.Tensor] = None, max_epochs: Optional[int] = None):
    """Baseline training loop (ref processor.py:11-164) → (state, history).

    ``train_loader.epoch(e)`` yields numpy batches; with ``TPU.DEVICE_DATASET``
    its records are decoded once onto the model's device instead."""
    solver = cfg.SOLVER
    epochs = max_epochs or solver.MAX_EPOCHS
    logger = rank_logger(logging.getLogger("mpreid_tpu_torch.train"))
    logger.info("start training")
    mesh, optimizer = data_parallel(cfg, optimizer, logger, model)

    with_center = "center" in cfg.MODEL.METRIC_LOSS_TYPE
    center = dict(center_weight=solver.CENTER_LOSS_WEIGHT if with_center else None,
                  center_lr=solver.CENTER_LR if with_center else None)
    train_step = make_train_step(model, cfg, loss_fn, optimizer, **center, mesh=mesh)
    train_epoch = make_train_epoch(model, cfg, loss_fn, optimizer, **center) \
        if cfg.TPU.DEVICE_DATASET and mesh is None else None
    state = initial_state(model, optimizer, centers=centers if with_center else None)
    start_epoch = 1
    if solver.RESUME:
        start_epoch = restore_state(state, load_checkpoint(solver.RESUME), optimizer) + 1
        logger.info(f"Resumed from {solver.RESUME} at epoch {start_epoch}")
    if mesh is not None:
        train_loader = start_data_parallel(state, optimizer, train_loader, mesh)

    all_start = time.monotonic()
    state, history = train_epochs(
        cfg, model, train_loader, val_loader, num_query, train_step, state, scheduler,
        start_epoch, epochs, solver.LOG_PERIOD, solver.CHECKPOINT_PERIOD, solver.EVAL_PERIOD,
        lambda e: cfg.OUTPUT_DIR and os.path.join(cfg.OUTPUT_DIR, f"{cfg.MODEL.NAME}_{e}.pth"),
        logger, train_epoch, cfg.TPU.PROFILE_DIR, optimizer, mesh)
    for compiled in (train_step, train_epoch):
        if compiled is not None:
            compiled.release()
    release_eval_steps(model)
    logger.info(f"Total running time: {timedelta(seconds=time.monotonic() - all_start)}")
    wait_for_pending_saves()  # surface a failed TPU.ASYNC_CHECKPOINT write
    return state, history
