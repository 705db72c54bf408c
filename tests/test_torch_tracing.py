"""The port's spans (``mpreid_tpu_torch/utils/tracing.py``) on the CPU.

- the facility: nesting (``parent``, ``root``), nothing recorded and no
  profiler range entered without a profiler, the bounded buffer, the
  window query, ``timed``, and the clock: under ``torch.profiler`` each
  in-memory span lies within 50 us of the profiler's own record of it;
- the port's spans as its entry points leave them under a profiler: a
  ``run_validation``, a ``make_train_epoch`` call, and stage 1's epoch with
  its trailing step (``do_train_stage1``), each with the nesting its
  modules' docstrings give, and ``capture_seconds`` from the capture's span.

Tiny Uni-Prompt model (``MODEL.DEBUG_TINY``, 64 x 32, fp32) on one thread;
nothing here imports JAX.
"""

import collections
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    do_train_stage1, initial_state, make_stage1_epoch, make_train_epoch,
    precompute_text_features, run_validation,
)
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import make_model_uniprompt
from mpreid_tpu_torch.solver import make_optimizer
from mpreid_tpu_torch.utils import tracing
from mpreid_tpu_torch.utils.tracing import span, timed

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

CLASSES = 4


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _profiled(fn):
    """``fn()`` under a CPU profiler → (its result, the profiler)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _by_index():
    return {s.index: s for s in tracing.spans()}


def _path(s, by_index):
    """The names from ``s``'s root down to ``s``."""
    names = [s.name]
    while s.parent >= 0:
        s = by_index[s.parent]
        names.append(s.name)
    return names[::-1]


def _paths():
    by_index = _by_index()
    return collections.Counter(tuple(_path(s, by_index)) for s in by_index.values())


# ---------------------------------------------------------------------------
# the facility
# ---------------------------------------------------------------------------

def test_spans_nest_with_their_parent_and_root():
    def run():
        with span("a.outer"):
            with span("b.mid"):
                with span("c.inner"):
                    pass
            with span("b.second"):
                pass
        with span("a.next"):
            pass

    _profiled(run)
    got = {s.name: s for s in tracing.spans()}
    assert set(got) == {"a.outer", "b.mid", "c.inner", "b.second", "a.next"}
    outer = got["a.outer"]
    assert (outer.parent, outer.root) == (-1, outer.index)
    assert (got["b.mid"].parent, got["b.mid"].root) == (outer.index, outer.index)
    assert (got["c.inner"].parent, got["c.inner"].root) == (got["b.mid"].index, outer.index)
    assert (got["b.second"].parent, got["b.second"].root) == (outer.index, outer.index)
    assert (got["a.next"].parent, got["a.next"].root) == (-1, got["a.next"].index)
    for s in got.values():
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = next(x for x in got.values() if x.index == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert [s.name for s in tracing.spans()][:3] == ["c.inner", "b.mid", "b.second"]


def test_without_a_profiler_nothing_is_recorded_or_entered(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_range", Spy)
    assert not tracing._profiler._is_profiler_enabled
    with span("a.outer"):
        with span("b.inner"):
            pass
    with timed("c.timed") as clock:
        pass
    assert tracing.spans() == [] and entered == []
    assert clock.seconds >= 0
    _profiled(lambda: span("a.outer").__enter__().__exit__(None, None, None))
    assert entered == ["a.outer"] and [s.name for s in tracing.spans()] == ["a.outer"]


def test_the_buffer_stays_bounded(monkeypatch):
    assert tracing._records.maxlen == tracing.CAPACITY == 1 << 18
    monkeypatch.setattr(tracing, "_records", collections.deque(maxlen=8))

    def run():
        for i in range(20):
            with span(f"s.{i}"):
                pass

    _profiled(run)
    kept = tracing.spans()
    assert [s.name for s in kept] == [f"s.{i}" for i in range(12, 20)]
    tracing.clear()
    assert tracing.spans() == []


def test_spans_in_a_window_and_a_timed_span():
    def run():
        with span("a.first"):
            pass
        with timed("b.timed") as clock:
            pass
        with span("c.last"):
            pass
        return clock

    clock, _ = _profiled(run)
    first, timed_span, last = sorted(tracing.spans(), key=lambda s: s.start_ns)
    assert timed_span.name == "b.timed"
    assert clock.seconds == (timed_span.end_ns - timed_span.start_ns) / 1e9
    inside = tracing.spans(timed_span.start_ns, timed_span.end_ns)
    assert [s.name for s in inside] == ["b.timed"]
    assert {s.name for s in tracing.spans(first.start_ns, last.start_ns)} == \
        {"a.first", "b.timed", "c.last"}


def test_spans_share_the_profilers_clock():
    """Each span's start and end within 50 us of the profiler's own record
    of the same range. A pause of the process between a stamp and the read
    beside it (the garbage collector, a preempted core) can part them once;
    a different clock parts them every time, so a measurement is taken up to
    three times."""
    names = ("a.outer", "b.inner", "c.inner")

    def run():
        with span("w.warm"):  # the first record of a session sets up the profiler's ops
            pass
        with span("a.outer"):
            with span("b.inner"):
                torch.ones(4).sum()
            with span("c.inner"):
                pass

    worst = []
    for _ in range(3):
        tracing.clear()
        enabled = gc.isenabled()
        gc.disable()
        try:
            _, prof = _profiled(run)
        finally:
            if enabled:
                gc.enable()
        theirs = {e.name(): e for e in prof.profiler.kineto_results.events()
                  if e.name() in names}
        mine = {s.name: s for s in tracing.spans() if s.name in names}
        assert set(mine) == set(theirs) == set(names)
        worst.append(max(max(abs(mine[n].start_ns - theirs[n].start_ns()),
                             abs(mine[n].end_ns - theirs[n].end_ns())) for n in names))
        if worst[-1] <= 50_000:
            break
    assert worst[-1] <= 50_000, worst


# ---------------------------------------------------------------------------
# the port's spans, as its entry points leave them
# ---------------------------------------------------------------------------

def _cfg():
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "ViT-B-16"
    cfg.MODEL.DEBUG_TINY = True
    cfg.MODEL.DEVICE = "cpu"
    cfg.INPUT.SIZE_TRAIN = [64, 32]
    cfg.INPUT.SIZE_TEST = [64, 32]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER.STAGE1.IMS_PER_BATCH = 8
    cfg.SOLVER.STAGE1.MAX_EPOCHS = 3
    cfg.SOLVER.STAGE1.LOG_PERIOD = 1000
    cfg.SOLVER.STAGE1.CHECKPOINT_PERIOD = 1000
    cfg.OUTPUT_DIR = ""
    return cfg


@pytest.fixture(scope="module")
def model():
    return make_model_uniprompt(_cfg(), CLASSES, 2, 1, device="cpu")


class _Loader:
    """An in-memory val loader: ``iter_sequential()`` of full-width batches."""

    def __init__(self, n: int, batch: int, hw=(64, 32), seed=0):
        rng = np.random.default_rng(seed)
        images = rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8)
        pids = np.arange(n, dtype=np.int32) % CLASSES
        camids = (np.arange(n, dtype=np.int32) // CLASSES) % 2
        self.batches = [{"images": images[i:i + batch], "pids": pids[i:i + batch],
                         "camids": camids[i:i + batch], "trackids": np.zeros(batch, np.int32),
                         "count": batch} for i in range(0, n, batch)]

    def iter_sequential(self):
        return iter(self.batches)


def test_run_validation_records_its_layers(model):
    cfg, loader = _cfg(), _Loader(40, 8)
    run_validation(cfg, model, loader, 16)  # two eager batches, the capture, replays
    tracing.clear()
    (cmc, mAP), _ = _profiled(lambda: run_validation(cfg, model, loader, 16))
    assert np.isfinite(mAP)
    paths = _paths()
    step = ("validation.pass", "steps.eval_step", "compiled.step")
    assert paths == {
        ("validation.pass",): 1,
        step[:2]: 5, step: 5,
        (*step, "compiled.key"): 5, (*step, "compiled.upload"): 5,
        (*step, "compiled.replay"): 5, (*step, "compiled.outputs"): 5,
        ("validation.pass", "evaluator.update"): 5,
        ("validation.pass", "evaluator.compute"): 1,
        ("validation.pass", "evaluator.compute", "evaluator.distances"): 1,
        ("validation.pass", "evaluator.compute", "evaluator.cmc_map"): 1,
        ("validation.pass", "evaluator.compute", "evaluator.fetch"): 1,
    }
    roots = {s.root for s in tracing.spans()}
    assert len(roots) == 1


def test_a_train_epoch_records_one_replay_per_row(model):
    cfg = _cfg()
    loss_fn, _ = make_loss(cfg, CLASSES)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    text = precompute_text_features(cfg, model, CLASSES)
    epoch = make_train_epoch(model, cfg, loss_fn, opt, uniprompt=True, text_features=text)
    state = initial_state(model, opt)
    rng = np.random.default_rng(0)
    n = 16
    data = (torch.from_numpy(rng.integers(0, 256, (n, 64, 32, 3), dtype=np.uint8)),
            (torch.arange(n, dtype=torch.int32) // 2) % CLASSES,
            torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32))
    gen = torch.Generator().manual_seed(0)
    rows = np.arange(n).reshape(4, 4)

    def run():
        return epoch(state, *data, rows, 1e-4, gen)

    _, prof = _profiled(run)  # two warm-up rows, the capture, two replays
    paths = _paths()
    top = ("steps.train_epoch", "compiled.epoch")
    assert paths == {top[:1]: 1, top: 1, (*top, "compiled.upload"): 1,
                     (*top, "compiled.key"): 1, (*top, "compiled.warmup"): 2,
                     (*top, "compiled.capture"): 1, (*top, "compiled.replay"): 2}
    tracing.clear()
    _profiled(run)  # every row replays
    assert _paths()[(*top, "compiled.replay")] == len(rows)
    assert {e.name for e in prof.events()} >= {"steps.train_epoch", "compiled.replay"}
    epoch.release()


def test_stage1_epochs_record_their_trailing_step(model):
    cfg = _cfg()
    opt = make_optimizer(cfg.SOLVER.STAGE1, model, stage="stage1a")
    n = 30  # three full batches of 8 and a trailing 6
    rng = np.random.default_rng(1)
    bank = (torch.from_numpy(rng.standard_normal((n, 32)).astype(np.float32)),
            np.arange(n) % CLASSES, np.zeros(n, np.int64))
    _, prof = _profiled(lambda: do_train_stage1(cfg, model, None, opt, lambda e: 1e-4,
                                                bank=bank))
    paths = _paths()
    ep, tr = ("stage1.epoch",), ("stage1.epoch", "stage1.trailing")
    steps1 = (*ep, "steps.stage1_epoch", "compiled.epoch")
    assert paths[ep] == 3 and paths[tr] == 3
    assert paths[(*ep, "stage1.fetch")] == 3 and paths[(*tr, "stage1.fetch")] == 3
    assert paths[steps1] == 3
    # the epoch's graph: 2 eager rows and a capture in epoch 1, then replays only
    assert paths[(*steps1, "compiled.warmup")] == 2 and paths[(*steps1, "compiled.capture")] == 1
    assert paths[(*steps1, "compiled.replay")] == 1 + 3 + 3
    # the trailing step: eager twice, then captured and replayed
    step = (*tr, "steps.stage1_step", "compiled.step")
    assert paths[step] == 3 and paths[(*step, "compiled.warmup")] == 2
    assert paths[(*step, "compiled.capture")] == 1 and paths[(*step, "compiled.replay")] == 1
    by_root = collections.Counter(s.root for s in tracing.spans())
    assert len(by_root) == 3  # one identifier an epoch


def test_capture_seconds_is_the_capture_spans_time(model):
    """A capture times itself whether or not a profiler records, and is
    kept only under one; ``capture_seconds`` sums the captures' spans."""
    cfg = _cfg()
    opt = make_optimizer(cfg.SOLVER.STAGE1, model, stage="stage1a")
    rng = np.random.default_rng(2)
    bank = (torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)),
            torch.arange(16) % CLASSES, torch.zeros(16, dtype=torch.long))
    epoch = make_stage1_epoch(model, cfg, opt, "1a")
    state = initial_state(model, opt)
    rows = np.arange(16).reshape(2, 8)
    assert epoch.compiled.capture_seconds == 0.0
    epoch(state, *bank, np.concatenate([rows, rows]), 1e-4)  # captures at its third row
    first = epoch.compiled.capture_seconds
    assert first > 0 and tracing.spans() == []
    epoch.release()
    _profiled(lambda: epoch(state, *bank, np.concatenate([rows, rows]), 1e-4))
    (capture,) = [s for s in tracing.spans() if s.name == "compiled.capture"]
    assert epoch.compiled.capture_seconds == first + (capture.end_ns - capture.start_ns) / 1e9
    epoch.release()
