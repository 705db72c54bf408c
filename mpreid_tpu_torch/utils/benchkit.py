"""The measured programs: one source for every harness that times the port.

ref mpreid_tpu/utils/benchkit.py. The JAX package's bench and A/B tools
time the programs its benchkit builds, so that two numbers taken through
it are measurements of one program (hand copies of the eval scan and the
stage-2 loop had drifted apart). This module is the port's counterpart,
with the same names, draws and return contracts:

- ``uniprompt_model`` / ``uniprompt_env`` (ref ``:32-73``), ``rn50_model`` /
  ``rn50_env`` (ref ``:76-104``): the bench models. A PyTorch module holds
  its weights, so ``*_env`` returns ``(cfg, model)``: seeded from a
  ``torch.Generator`` (seeds 0 and 1 where the JAX package takes
  ``PRNGKey(0)`` and ``(1)``), on ``cfg.MODEL.DEVICE`` through
  ``utils/device.py``, so on the card unless the caller asks for ``cpu``;
  ``*_model`` builds on the meta device (shapes, no weights).
- ``SyntheticValLoader`` (ref ``:107-146``), ``synthetic_train_batch`` (ref
  ``:149-164``): the same ``np.random.RandomState`` draws in the same order
  (the same bytes as the JAX package's), as tensors on the model's device.
- ``make_eval_scan`` / ``make_tta_scan`` (ref ``:171-253``): ``iters``
  chained forwards, each fed ``images_u8 + carry`` (uint8, wrapping mod
  256) with the carry ``uint8(s > 1e30)`` of the previous forward's sum
  ``s``; the result is the sum of the sums, one fetch.
- ``stage1_harness`` + ``epoch_window`` (ref ``:260-323``) over
  ``engine/steps.py::make_stage1_epoch``; ``stage2_harness``,
  ``baseline_harness`` + ``step_window`` (ref ``:330-419``) over
  ``make_train_step``, with a seeded ``torch.Generator`` on the device in
  place of JAX's fixed key (``gen``).
- ``timed``, ``best_of`` (ref ``:422-441``).

What differs, and why:

- Every window ends in one fetch to the host (``.tolist()``), which
  synchronises the device: the time covers all the work of the window, and
  nothing inside a window waits for the device.
- A harness trains a copy of the caller's model (the JAX harness copies the
  variables), so harnesses built from one model do not see each other's
  updates; ``with_state=False`` skips the copy and the moments.
- The steps are ``engine/compiled.py``'s: two eager calls a key, a CUDA
  graph captured at the third, replays after it. The eval and TTA scans
  run their forward through a ``CompiledStep`` too (the forward's graph
  replayed ``iters`` times, the carry kept on the device), not as one graph
  of the whole window: the window's graph would hold ``iters`` copies of
  the forward's kernels for nothing, and the forward's is the graph the
  eval loop replays. Each window says in ``run.warmup`` how many windows
  must run before its replays start; ``best_of`` discards that many by
  default, so the windows it times are replays only, and ``graph_stats``
  reports the capture's seconds apart from them.
- ``release(h)`` frees a harness's or a window's graph and memory pool and
  what it holds on the device (its state, bank, batch, images): the
  counterpart of ``with_state=False`` and of the JAX bench dropping a state.

Nothing falls back: a failed capture raises, and nothing runs on the CPU
unless the caller asks for it.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine.compiled import WARMUP_STEPS, CompiledStep
from mpreid_tpu_torch.engine.steps import (
    _device_of, make_stage1_epoch, make_train_step, module_tensors,
)
from mpreid_tpu_torch.engine.train_state import initial_state
from mpreid_tpu_torch.engine.ttpt import tta_aggregate
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models.factory import build_model, build_model_uniprompt
from mpreid_tpu_torch.ops.augment import eval_preprocess
from mpreid_tpu_torch.solver import make_optimizer
from mpreid_tpu_torch.utils.device import device_from_cfg, resolve_device


# ---------------------------------------------------------------------------
# the bench models
# ---------------------------------------------------------------------------

def _bench_cfg(name: str, size, debug_tiny: bool, device):
    cfg = get_default_cfg()
    cfg.MODEL.NAME = name
    cfg.MODEL.DEBUG_TINY = debug_tiny
    cfg.INPUT.SIZE_TRAIN = list(size)
    cfg.INPUT.SIZE_TEST = list(size)
    cfg.DATALOADER.SAMPLER = "softmax_triplet"
    if device is not None:
        cfg.MODEL.DEVICE = str(device)
    return cfg


def _seeded(cfg, model, seed: int):
    """``model`` (built on the CPU) initialised from ``seed``, on the
    config's device, in eval mode."""
    device = device_from_cfg(cfg)
    model.init_(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def uniprompt_model(num_classes: int = 1000, camera_num: int = 14, view_num: int = 1,
                    size: Tuple[int, int] = (256, 128), debug_tiny: bool = False,
                    device=None):
    """(cfg, model): the Uni-Prompt bench model (ref ``uniprompt_model``),
    ViT-B/16 at ``size`` with the cctv yml's loss settings (PK sampler, ID
    weight 0.25), built on the meta device: its shapes (``clip_config``,
    the parameter count) and no weights. ``device`` sets ``MODEL.DEVICE``
    (by default the card)."""
    cfg = _bench_cfg("ViT-B-16", size, debug_tiny, device)
    cfg.MODEL.ID_LOSS_WEIGHT = 0.25
    with torch.device("meta"):
        model = build_model_uniprompt(cfg, num_classes, camera_num, view_num)
    return cfg, model


def uniprompt_env(num_classes: int = 1000, camera_num: int = 14, view_num: int = 1,
                  size: Tuple[int, int] = (256, 128), debug_tiny: bool = False,
                  device=None):
    """(cfg, model): ``uniprompt_model``'s model with weights seeded from 0
    on its device (ref ``uniprompt_env``, ``PRNGKey(0)``). ``debug_tiny``
    shrinks the towers (``MODEL.DEBUG_TINY``) for CPU tests of the harness
    itself."""
    cfg, _ = uniprompt_model(num_classes, camera_num, view_num, size, debug_tiny, device)
    return cfg, _seeded(cfg, build_model_uniprompt(cfg, num_classes, camera_num, view_num), 0)


def rn50_model(num_classes: int = 1000, camera_num: int = 14,
               size: Tuple[int, int] = (256, 128), debug_tiny: bool = False,
               device=None):
    """(cfg, model): the RN50 baseline bench model (ref ``rn50_model``) on
    the meta device."""
    cfg = _bench_cfg("RN50", size, debug_tiny, device)
    with torch.device("meta"):
        model = build_model(cfg, num_classes, camera_num, 1)
    return cfg, model


def rn50_env(num_classes: int = 1000, camera_num: int = 14,
             size: Tuple[int, int] = (256, 128), debug_tiny: bool = False,
             device=None):
    """(cfg, model): the RN50 baseline bench model (ref ``rn50_env``, the
    configs/person/cnn_base.yml path) with weights seeded from 1 (ref
    ``PRNGKey(1)``) on its device."""
    cfg, _ = rn50_model(num_classes, camera_num, size, debug_tiny, device)
    return cfg, _seeded(cfg, build_model(cfg, num_classes, camera_num, 1), 1)


# ---------------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------------

def _on(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


class SyntheticValLoader:
    """In-memory val loader (query rows first, then gallery) whose image
    batches are uint8 tensors already on the device (ref
    ``SyntheticValLoader``): the public eval entry points
    (``engine/ttpt.py::do_inference_tta``, ``::do_inference_ttpt``) run on
    it with no upload of images. pids are drawn from ``n_ids`` so CMC and
    mAP have real matches; camids cycle over 6 so the same-pid same-camera
    filter keeps positives. The batches lie on ``cfg.MODEL.DEVICE``."""

    def __init__(self, cfg, num_query_batches: int, num_gallery_batches: int, batch: int,
                 n_ids: int = 32, rng: Optional[np.random.RandomState] = None):
        rng = rng if rng is not None else np.random.RandomState(0)
        device = resolve_device(cfg.MODEL.DEVICE)
        h, w = cfg.INPUT.SIZE_TEST
        total_batches = num_query_batches + num_gallery_batches
        total = total_batches * batch
        pids = rng.randint(0, n_ids, total).astype(np.int32)
        camids = (np.arange(total) % 6).astype(np.int32)
        self.num_query = num_query_batches * batch
        self.total = total
        self._batches = []
        for i in range(total_batches):
            sl = slice(i * batch, (i + 1) * batch)
            self._batches.append({
                "images": _on(rng.randint(0, 255, (batch, h, w, 3), dtype=np.uint8), device),
                "pids": pids[sl],
                "camids": camids[sl],
                "trackids": np.zeros(batch, np.int32),
                "paths": [""] * batch,
                "count": batch,
            })

    def iter_sequential(self):
        return iter(self._batches)


def synthetic_train_batch(batch: int = 64, num_classes: int = 1000,
                          hw: Tuple[int, int] = (256, 128),
                          rng: Optional[np.random.RandomState] = None,
                          device=None) -> Dict[str, torch.Tensor]:
    """The synthetic PK train batch (K = 4 instances per identity; ref
    ``synthetic_train_batch``), every tensor on ``device`` (by default the
    card)."""
    rng = rng if rng is not None else np.random.RandomState(0)
    device = resolve_device("cuda" if device is None else device)
    h, w = hw
    return {
        "images": _on(rng.randint(0, 255, (batch, h, w, 3), dtype=np.uint8), device),
        "pids": _on((np.arange(batch) // 4 % num_classes).astype(np.int32), device),
        "camids": torch.zeros(batch, dtype=torch.int32, device=device),
        "trackids": torch.zeros(batch, dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# eval forwards (gallery extraction): the forward's graph replayed per window
# ---------------------------------------------------------------------------

class ScanWindow:
    """``run() -> float``: ``iters`` chained forwards of one uint8 batch (ref
    ``make_eval_scan``'s ``lax.scan``): forward ``i`` reads ``images_u8 +
    carry``, summed in uint8, and writes ``carry = uint8(s > 1e30)`` of its
    own features' sum ``s`` on the device, so each forward waits for the one
    before and the result depends on every output element. The forward runs
    through a ``CompiledStep`` (``compiled``): eager at its first two calls,
    then one captured graph replayed. The carry starts at 0 in each window;
    the window ends in one fetch of the sum of the sums.

    ``eager()`` runs the same window with the forward called directly (the
    graph's reference); ``warmup`` is the windows that run before the first
    one of replays only; ``release()`` frees the graph and the images."""

    def __init__(self, model, features: Callable[[torch.Tensor], torch.Tensor],
                 images: torch.Tensor, iters: int, mean, std):
        self.model = model
        self.features = features
        self.mean, self.std = tuple(mean), tuple(std)
        self.images = images
        self.carry = torch.zeros((), dtype=torch.uint8, device=images.device)
        self.iters = iters
        self.warmup = warmup_windows(iters)
        self.compiled = CompiledStep(images.device)

    @torch.no_grad()
    def _body(self) -> Tuple[torch.Tensor]:
        x = eval_preprocess(self.images + self.carry, mean=self.mean, std=self.std)
        s = torch.sum(self.features(x).float())
        self.carry.copy_((s > 1e30).to(torch.uint8))
        return (s,)

    def _window(self, forward: Callable[[], Tuple[torch.Tensor]]) -> float:
        self.carry.zero_()
        sums = [forward()[0] for _ in range(self.iters)]
        return torch.sum(torch.stack(sums)).tolist()

    def __call__(self) -> float:
        bound = [*module_tensors(self.model), self.images, self.carry]
        return self._window(lambda: self.compiled(self._body, (), bound=bound))

    def eager(self) -> float:
        return self._window(self._body)

    def release(self) -> None:
        self.compiled.release()
        self.images = self.carry = None


def _scan_images(cfg, batch: int, rng, device) -> torch.Tensor:
    rng = rng if rng is not None else np.random.RandomState(0)
    h, w = cfg.INPUT.SIZE_TEST
    return _on(rng.randint(0, 255, (batch, h, w, 3), dtype=np.uint8), device)


def make_eval_scan(cfg, model, batch: int = 128, iters: int = 40,
                   rng: Optional[np.random.RandomState] = None) -> ScanWindow:
    """``run() -> float``: one eval window, ``iters`` forwards
    (``forward_eval``: BNNeck features) of a ``batch`` of synthetic images
    (ref ``make_eval_scan``; the model holds its weights, so no ``params``
    or ``batch_stats``). Batch 128 and 40 iterations are the JAX bench's."""
    images = _scan_images(cfg, batch, rng, _device_of(model))
    return ScanWindow(model, model.forward_eval, images, iters,
                      cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD)


def make_tta_scan(cfg, model, batch: int = 128, iters: int = 10,
                  rng: Optional[np.random.RandomState] = None) -> ScanWindow:
    """``run() -> float``: TTA query-feature windows (ref ``make_tta_scan``):
    per image the mean feature over {original, h-flip, pseudo-IR,
    pseudo-RGB}, aggregated by the engine's own ``engine/ttpt.py::
    tta_aggregate``, then L2-normalised; about 4× an eval forward."""
    images = _scan_images(cfg, batch, rng, _device_of(model))

    def features(x):
        f, _ = tta_aggregate(model.forward_eval, x)
        return f / torch.linalg.norm(f, dim=1, keepdim=True)

    return ScanWindow(model, features, images, iters, cfg.INPUT.PIXEL_MEAN,
                      cfg.INPUT.PIXEL_STD)


# ---------------------------------------------------------------------------
# stage-1 prompt-training epochs
# ---------------------------------------------------------------------------

def _trained_model(model, with_state: bool):
    """The model a harness trains: a copy of the caller's, as the JAX
    harness copies the variables; the caller's own without a state."""
    return copy.deepcopy(model) if with_state else model


def stage1_harness(cfg, model, stage: str = "1a", iters: int = 50, batch: int = 64,
                   num_classes: int = 1000, embed_dim: int = 512, random_views: bool = False,
                   rng: Optional[np.random.RandomState] = None,
                   with_state: bool = True) -> Dict[str, Any]:
    """The stage-1 prompt-training workload (ref ``stage1_harness``: 50
    iterations × batch 64, the text tower's forward and backward and SupCon
    against a bank of precomputed features, ref
    processor_uniprompt_stage1.py:66-107). The epoch runs as
    ``do_train_stage1`` runs it: one ``make_stage1_epoch`` call over the
    bank on the device (``CompiledEpoch``: two eager rows, then one graph
    replayed a row). Bank, labels, views and ``perm`` are drawn in the JAX
    harness's order. ``random_views=True`` draws real view labels (stage 1b
    trains the modality and platform contexts on them);
    ``with_state=False`` builds no state (the step count, the moments, the
    model's copy) for callers that need only the other parts.

    → {"epoch_fn", "state", "opt", "bank", "labels", "views", "perm",
    "iters", "batch"}."""
    rng = rng if rng is not None else np.random.RandomState(0)
    device = _device_of(model)
    stage_cfg = cfg.SOLVER.STAGE1B if stage == "1b" else cfg.SOLVER.STAGE1A
    trained = _trained_model(model, with_state)
    opt = make_optimizer(stage_cfg, trained, stage=f"stage{stage}")
    epoch_fn = make_stage1_epoch(trained, cfg, opt, stage=stage)
    state = initial_state(trained, opt) if with_state else None
    n = iters * batch
    bank = _on(rng.randn(n, embed_dim).astype(np.float32), device)
    labels = _on(rng.randint(0, num_classes, n).astype(np.int32), device)
    views = (_on(rng.randint(0, 14, n).astype(np.int32), device) if random_views
             else torch.zeros(n, dtype=torch.int32, device=device))
    perm = torch.arange(n, device=device).reshape(iters, batch)
    return {"epoch_fn": epoch_fn, "state": state, "opt": opt, "bank": bank,
            "labels": labels, "views": views, "perm": perm, "iters": iters, "batch": batch}


def _fetch(value: torch.Tensor, model, opt) -> None:
    """The window's one fetch: ``value``'s sum and one trained parameter's,
    read together (the device's work of the window is done after it)."""
    train, _ = opt.partition(model)
    first = next(iter(train.values()))
    torch.stack([value.float().sum(), first.detach().float().sum()]).tolist()


def epoch_window(harness: Dict[str, Any], lr: float = 3.5e-4) -> Callable[[], float]:
    """``run() -> seconds``: one stage-1 epoch (ref ``epoch_window``), the
    losses and a parameter fetched, the state threaded through ``harness``
    (whose ``"losses"`` holds the last window's). The first call warms up
    and captures (an epoch of more than ``WARMUP_STEPS`` rows), every later
    one replays only."""

    def run() -> float:
        h = harness
        t0 = time.perf_counter()
        state, losses = h["epoch_fn"](h["state"], h["bank"], h["labels"], h["views"],
                                      h["perm"], lr)
        _fetch(losses, state.model, h["opt"])
        h["state"], h["losses"] = state, losses
        return time.perf_counter() - t0

    run.warmup = 1
    return run


# ---------------------------------------------------------------------------
# train-step harnesses
# ---------------------------------------------------------------------------

def _step_harness(cfg, model, opt_cfg, stage: str, num_classes: int, batch: int, rng,
                  text_features: Optional[torch.Tensor], with_state: bool) -> Dict[str, Any]:
    device = _device_of(model)
    loss_fn, _ = make_loss(cfg, num_classes)
    trained = _trained_model(model, with_state)
    opt = make_optimizer(opt_cfg, trained, stage=stage)
    step = make_train_step(trained, cfg, loss_fn, opt, uniprompt=text_features is not None,
                           text_features=text_features)
    state = initial_state(trained, opt) if with_state else None
    b = synthetic_train_batch(batch, num_classes, tuple(cfg.INPUT.SIZE_TRAIN), rng, device)
    return {"step": step, "state": state, "batch": b,
            "gen": torch.Generator(device).manual_seed(0),
            "loss_fn": loss_fn, "opt": opt, "text_features": text_features}


def stage2_harness(cfg, model, num_classes: int = 1000, batch: int = 64,
                   stage: str = "stage2a", rng: Optional[np.random.RandomState] = None,
                   embed_dim: int = 512, with_state: bool = True) -> Dict[str, Any]:
    """The stage-2 fine-tune step (ref ``stage2_harness``: the whole forward
    and backward, ID + triplet + i2t losses, Adam; ref
    processor_uniprompt_stage2.py:88-156) through ``make_train_step``.

    → {"step", "state", "batch" (the synthetic PK batch on the device),
    "gen" (a seeded generator on the device, in place of JAX's ``key``),
    "loss_fn", "opt", "text_features"}. ``text_features`` is drawn before
    the batch, as the JAX harness draws it."""
    rng = rng if rng is not None else np.random.RandomState(0)
    text_features = _on(rng.randn(num_classes, embed_dim).astype(np.float32),
                        _device_of(model))
    return _step_harness(cfg, model, cfg.SOLVER.STAGE2, stage, num_classes, batch, rng,
                         text_features, with_state)


def baseline_harness(cfg, model, num_classes: int = 1000, batch: int = 64,
                     rng: Optional[np.random.RandomState] = None) -> Dict[str, Any]:
    """The baseline train step (ref ``baseline_harness``, ref
    processor/processor.py:61-88), the RN50 path. Same return contract as
    ``stage2_harness``, with ``text_features`` None."""
    rng = rng if rng is not None else np.random.RandomState(0)
    return _step_harness(cfg, model, cfg.SOLVER, "baseline", num_classes, batch, rng, None,
                         True)


def step_window(harness: Dict[str, Any], iters: int = 20,
                lr: float = 5e-6) -> Callable[[], float]:
    """``run() -> seconds``: ``iters`` back-to-back steps (ref
    ``step_window``), one loss and one parameter fetched at the end, the
    state threaded through ``harness`` (whose ``"metrics"`` holds the last
    step's). ``run.warmup`` is the windows before the first of replays
    only: the step's first two calls run eagerly and the third captures."""

    def run() -> float:
        h = harness
        step, b, gen, state = h["step"], h["batch"], h["gen"], h["state"]
        t0 = time.perf_counter()
        for _ in range(iters):
            state, m = step(state, b, lr, gen)
        _fetch(m["loss"], state.model, h["opt"])
        h["state"], h["metrics"] = state, m
        return time.perf_counter() - t0

    run.warmup = warmup_windows(iters)
    return run


# ---------------------------------------------------------------------------
# timing, graph statistics, release
# ---------------------------------------------------------------------------

def warmup_windows(calls: int) -> int:
    """The windows of ``calls`` calls each of one compiled step that run
    before the first window made of replays only: the step's first
    ``WARMUP_STEPS`` calls are eager and the next captures."""
    return -(-(WARMUP_STEPS + 1) // calls)


def timed(run: Callable[[], Any]) -> Callable[[], float]:
    """A value-fetching runner (``make_eval_scan``'s) as a seconds-returning
    one for ``best_of`` (ref ``timed``); it keeps the runner's ``warmup``."""

    def f() -> float:
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0

    f.warmup = getattr(run, "warmup", 1)
    return f


def best_of(run: Callable[[], float], windows: int = 2, warmup: Optional[int] = None) -> float:
    """The least of ``windows`` timed windows after ``warmup`` discarded ones
    (ref ``best_of``). By default ``warmup`` is what the runner declares
    (``run.warmup``, else 1), so the windows timed hold no eager step and no
    capture; fewer raises."""
    need = getattr(run, "warmup", 1)
    warmup = need if warmup is None else warmup
    if warmup < need:
        raise ValueError(f"warmup {warmup}: this runner's first {need} windows are not replays "
                         "only")
    for _ in range(warmup):
        run()
    return min(run() for _ in range(windows))


def _compiled_of(h):
    if isinstance(h, dict):
        fn = h.get("epoch_fn", h.get("step"))
        return None if fn is None else fn.compiled
    return h.compiled


def graph_stats(h) -> Dict[str, Any]:
    """A harness's or a window's compiled runner: captures, replays, eager
    steps, the graph pool's bytes and the seconds spent capturing."""
    compiled = _compiled_of(h)
    return dict(compiled.stats, capture_seconds=compiled.capture_seconds)


def release(h) -> None:
    """Free a harness's or a window's graph and memory pool, and what it
    holds on the device: a harness's state (its model copy, moments and
    step), bank or batch and text features, which are dropped (the dict is
    emptied); a window's images. Then the allocator's free blocks go back
    to the device."""
    if isinstance(h, dict):
        compiled = _compiled_of(h)
        if compiled is not None:
            compiled.release()
        h.clear()
    else:
        h.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
