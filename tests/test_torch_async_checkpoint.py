"""``TPU.ASYNC_CHECKPOINT`` in the port: the checkpoint written on a background thread.

ref tests/test_engine.py::test_checkpoint_async_roundtrip_and_error and
mpreid_tpu/utils/checkpoint.py:135-197. With the key on,
``utils/checkpoint.py::save_checkpoint`` copies the state to the host in
the caller's thread and writes it on one thread; a new save, a load and
``wait_for_pending_saves`` join the write first, and a failed write
surfaces there as ``RuntimeError("async checkpoint write to ... failed")``,
once. Checked here:

* a round trip bit for bit, and the same bytes of state as a blocking save;
* the state mutated in place after the save and before the join (the
  writer held back until then): the file holds the values at save time,
  since a CPU tensor's ``.cpu()`` would alias the live parameters;
* a failed write (a path under a file) surfacing once at the join, and at
  the next save;
* ``load_checkpoint`` and ``models/convert.py::load_param`` joining a
  write in flight;
* ``do_train`` with the key on equal to it off (history, weights and
  every checkpoint file), and ``do_train``, ``do_train_stage1`` and
  ``do_train_stage2`` joining before they return;
* two gloo ranks under ``TPU.ZERO_OPT_STATE``: rank 0 alone writes, the
  moments gathered, the files equal to a blocking run's.

Tiny ViT (``MODEL.DEBUG_TINY``) in fp32 on the CPU. This module imports
nothing of JAX at its top: the spawned ranks import it to find their
function.
"""

import os
import threading

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.engine import (
    do_train, do_train_stage1, do_train_stage2, initial_state, make_train_step,
)
from mpreid_tpu_torch.engine import processor
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import load_param, make_model, make_model_uniprompt
from mpreid_tpu_torch.parallel.launch import spawn
from mpreid_tpu_torch.solver import make_optimizer
from mpreid_tpu_torch.utils import checkpoint as ckpt
from mpreid_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint, wait_for_pending_saves,
)

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)


def _cfg(root="", out="", asynchronous=True, **overrides):
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE, cfg.MODEL.NAME, cfg.MODEL.DEBUG_TINY = "cpu", "ViT-B-16", True
    cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = [32, 16]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TPU.ASYNC_CHECKPOINT = asynchronous
    cfg.DATASETS.NAMES, cfg.DATASETS.ROOT_DIR = "market1501", root
    cfg.DATALOADER.NUM_WORKERS = 2
    cfg.SOLVER.IMS_PER_BATCH = cfg.SOLVER.STAGE2.IMS_PER_BATCH = 8
    cfg.SOLVER.STAGE1.IMS_PER_BATCH = 8
    cfg.SOLVER.CHECKPOINT_PERIOD = cfg.SOLVER.STAGE2.CHECKPOINT_PERIOD = 1
    cfg.SOLVER.STAGE1.CHECKPOINT_PERIOD = 1
    cfg.SOLVER.EVAL_PERIOD = cfg.SOLVER.STAGE2.EVAL_PERIOD = 100
    cfg.SOLVER.LOG_PERIOD = cfg.SOLVER.STAGE2.LOG_PERIOD = 1000
    cfg.OUTPUT_DIR = str(out)
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


def _trained_state(cfg):
    """A tiny baseline model and its Adam state after one step (the moments
    are not zero)."""
    model = make_model(cfg, 8, 14, 1)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    state = initial_state(model, opt)
    rng = np.random.default_rng(0)
    batch = {"images": rng.integers(0, 256, (8, 32, 16, 3), dtype=np.uint8),
             "pids": np.repeat(np.arange(2), 4).astype(np.int32),
             "camids": np.zeros(8, np.int32), "trackids": np.zeros(8, np.int32)}
    step = make_train_step(model, cfg, make_loss(cfg, 8)[0], opt)
    state, _ = step(state, batch, 1e-3, torch.Generator().manual_seed(0))
    return state


def _snapshot(state) -> dict:
    return {"model": {k: v.clone() for k, v in state.model.state_dict().items()},
            "mu": {k: v.clone() for k, v in state.opt_state.mu.items()},
            "nu": {k: v.clone() for k, v in state.opt_state.nu.items()},
            "step": int(state.opt_state.step)}


def _assert_payload_equals(payload, want):
    assert payload["opt_state"]["step"] == want["step"]
    for part, tensors in (("model", payload["model"]), ("mu", payload["opt_state"]["mu"]),
                          ("nu", payload["opt_state"]["nu"])):
        assert set(tensors) == set(want[part]), part
        for k, v in want[part].items():
            assert tensors[k].dtype == v.dtype and torch.equal(tensors[k], v), (part, k)


@pytest.fixture
def held_writer(monkeypatch):
    """``torch.save`` of the writer thread held back until the returned
    event is set (the caller's own saves pass)."""
    release = threading.Event()
    real = torch.save

    def held(*args, **kwargs):
        if threading.current_thread().name == "mpreid-ckpt-writer":
            assert release.wait(30)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "save", held)
    yield release
    release.set()
    wait_for_pending_saves()


# ---------------------------------------------------------------------------
# save_checkpoint and the joins
# ---------------------------------------------------------------------------

def test_async_checkpoint_round_trips_bit_for_bit(tmp_path):
    cfg = _cfg()
    state = _trained_state(cfg)
    want = _snapshot(state)
    path = str(tmp_path / "async.pth")
    assert save_checkpoint(path, state, 3, cfg) == path
    payload = load_checkpoint(path)  # joins the write
    assert payload["epoch"] == 3 and not ckpt._PENDING_SAVE
    _assert_payload_equals(payload, want)
    # the same state as a blocking save writes
    save_checkpoint(str(tmp_path / "sync.pth"), state, 3, _cfg(asynchronous=False))
    _assert_payload_equals(load_checkpoint(str(tmp_path / "sync.pth")), want)
    wait_for_pending_saves()  # nothing pending: a no-op


def test_async_checkpoint_holds_the_state_at_save_time(tmp_path, held_writer):
    """The optimizer updates parameters and moments in place: after the
    save returns the state is changed, then the writer runs."""
    cfg = _cfg()
    state = _trained_state(cfg)
    want = _snapshot(state)
    path = str(tmp_path / "held.pth")
    save_checkpoint(path, state, 1, cfg)
    assert ckpt._PENDING_SAVE and not os.path.exists(path)
    with torch.no_grad():
        for t in [*state.model.state_dict().values(), *state.opt_state.mu.values(),
                  *state.opt_state.nu.values()]:
            if t.is_floating_point():
                t.add_(1.0)
    held_writer.set()
    wait_for_pending_saves()
    _assert_payload_equals(load_checkpoint(path), want)


def test_a_failed_async_write_surfaces_once_at_the_join(tmp_path):
    cfg = _cfg()
    state = _trained_state(cfg)
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    save_checkpoint(str(blocker / "ckpt.pth"), state, 1, cfg)  # returns: the write failed later
    with pytest.raises(RuntimeError, match="async checkpoint write") as err:
        wait_for_pending_saves()
    assert str(blocker / "ckpt.pth") in str(err.value) and err.value.__cause__ is not None
    wait_for_pending_saves()  # the failed slot is consumed


def test_a_failed_async_write_surfaces_at_the_next_save(tmp_path):
    cfg = _cfg()
    state = _trained_state(cfg)
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    save_checkpoint(str(blocker / "ckpt.pth"), state, 1, cfg)
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        save_checkpoint(str(tmp_path / "next.pth"), state, 2, cfg)
    assert not ckpt._PENDING_SAVE and not os.path.exists(tmp_path / "next.pth")
    save_checkpoint(str(tmp_path / "next.pth"), state, 2, cfg)  # the slot is free again
    assert load_checkpoint(str(tmp_path / "next.pth"))["epoch"] == 2


@pytest.mark.parametrize("reader", ["load_checkpoint", "load_param"])
def test_loads_join_a_write_in_flight(tmp_path, held_writer, reader):
    """The reader blocks until the held write is released, then reads it."""
    cfg = _cfg()
    state = _trained_state(cfg)
    want = _snapshot(state)
    path = str(tmp_path / "in_flight.pth")
    save_checkpoint(path, state, 5, cfg)
    timer = threading.Timer(0.3, held_writer.set)
    timer.start()
    try:
        if reader == "load_checkpoint":
            assert load_checkpoint(path)["epoch"] == 5
        else:
            model = make_model(cfg, 8, 14, 1)
            load_param(path, model)
            for k, v in want["model"].items():
                assert torch.equal(model.state_dict()[k], v), k
    finally:
        timer.join()
    assert held_writer.is_set() and not ckpt._PENDING_SAVE


# ---------------------------------------------------------------------------
# the training loops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def market(tmp_path_factory):
    from mpreid_tpu_torch.data.synthetic import make_market1501

    root = tmp_path_factory.mktemp("m1501_async")
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    return str(root)


def _do_train(cfg, epochs=2):
    tl, _, _, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model(cfg, ncls, ncam, nview)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    state, history = do_train(cfg, model, tl, None, opt, lambda e: 1e-3,
                              make_loss(cfg, ncls)[0], nq, max_epochs=epochs)
    return history, {k: v.clone() for k, v in model.state_dict().items()}


def test_do_train_with_async_checkpoint_equals_it_off(market, tmp_path):
    runs = {on: _do_train(_cfg(market, tmp_path / str(on), asynchronous=on)) for on in
            (False, True)}
    assert not ckpt._PENDING_SAVE  # do_train joined its last write
    (h0, w0), (h1, w1) = runs[False], runs[True]
    assert h0 == h1
    for k, v in w0.items():
        assert torch.equal(w1[k], v), k
    for epoch in (1, 2):
        off, on = (load_checkpoint(str(tmp_path / str(m) / f"ViT-B-16_{epoch}.pth"))
                   for m in (False, True))
        assert off["epoch"] == on["epoch"] == epoch
        _assert_payload_equals(on, {"model": off["model"], "mu": off["opt_state"]["mu"],
                                    "nu": off["opt_state"]["nu"],
                                    "step": off["opt_state"]["step"]})


def _stage1(cfg):
    model = make_model_uniprompt(cfg, 4, 14, 1)
    rng = np.random.default_rng(0)
    bank = (torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)),
            np.repeat(np.arange(4), 4), np.zeros(16, np.int64))
    opt = make_optimizer(cfg.SOLVER.STAGE1A, model, stage="stage1a")
    do_train_stage1(cfg, model, None, opt, lambda e: 1e-3, bank=bank,
                    stage_cfg=cfg.SOLVER.STAGE1A)


def _stage2(cfg):
    tl, _, _, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model_uniprompt(cfg, ncls, ncam, nview)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    do_train_stage2(cfg, model, tl, None, opt, lambda e: 1e-3, make_loss(cfg, ncls)[0], nq,
                    ncls, max_epochs=1)


@pytest.mark.parametrize("loop", ["do_train", "do_train_stage1", "do_train_stage2"])
def test_the_training_loops_join_their_writes(market, tmp_path, loop):
    """Each loop returns only after its last write: with the output
    directory under a file, the write fails and the loop raises it."""
    run = {"do_train": lambda c: _do_train(c, epochs=1), "do_train_stage1": _stage1,
           "do_train_stage2": _stage2}[loop]
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    cfg = _cfg(market, blocker / "out", **{"SOLVER.STAGE1A.MAX_EPOCHS": 1,
                                           "SOLVER.STAGE1A.CHECKPOINT_PERIOD": 1,
                                           "SOLVER.STAGE1A.IMS_PER_BATCH": 8})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        run(cfg)
    assert not ckpt._PENDING_SAVE
    cfg.OUTPUT_DIR = str(tmp_path / "out")
    run(cfg)
    assert not ckpt._PENDING_SAVE and os.listdir(tmp_path / "out")


# ---------------------------------------------------------------------------
# two ranks under ZeRO-1
# ---------------------------------------------------------------------------

def _zero_job(root, out):
    """``do_train`` over two epochs under ``TPU.ZERO_OPT_STATE``, async off
    and on, counting each rank's calls of ``save_checkpoint``."""
    calls = []
    real = processor.save_checkpoint

    def counted(path, *args):
        calls.append(os.path.basename(os.path.dirname(path)))
        return real(path, *args)

    processor.save_checkpoint = counted
    try:
        for on in (False, True):
            cfg = _cfg(root, os.path.join(out, str(on)), asynchronous=on,
                       **{"SOLVER.IMS_PER_BATCH": 16, "TPU.ZERO_OPT_STATE": True})
            _do_train(cfg)
        pending = list(ckpt._PENDING_SAVE)
    finally:
        processor.save_checkpoint = real
    return {"calls": calls, "pending": len(pending)}


@pytest.fixture(scope="module")
def zero_ranks(market, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("async_zero"))
    return spawn(_zero_job, 2, (market, out), timeout=300, threads=2), out


def test_zero_ranks_write_from_rank_0_only(zero_ranks):
    ranks, out = zero_ranks
    assert ranks[0]["calls"] == ["False", "False", "True", "True"]
    assert ranks[1]["calls"] == []
    assert ranks[0]["pending"] == ranks[1]["pending"] == 0
    for epoch in (1, 2):
        off, on = (load_checkpoint(os.path.join(out, m, f"ViT-B-16_{epoch}.pth"))
                   for m in ("False", "True"))
        _assert_payload_equals(on, {"model": off["model"], "mu": off["opt_state"]["mu"],
                                    "nu": off["opt_state"]["nu"],
                                    "step": off["opt_state"]["step"]})
        # the moments are whole (gathered over the ranks), at the parameters' shapes
        for k, m in on["opt_state"]["mu"].items():
            assert m.shape == on["model"][k].shape, k
