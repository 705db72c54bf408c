"""The port's compiled steps (``engine/compiled.py::CompiledStep``):
``make_eval_step``, ``make_image_bank_step``, ``make_text_step``,
``make_train_step`` and ``make_stage1_step``, and the eval-step cache of
``run_validation``.

On the CPU a compiled step takes the card's decisions (two eager warm-up
calls a key, a capture at the third, replays after it) with a stand-in for
the graph whose replay runs the body eagerly on the static input buffers
and copies its outputs into the static ones, so these tests hold everything
but the capture itself (the ``cuda``-marked cases in
tests/test_torch_cuda.py hold the graphs on the card):

- (a) each step, over enough calls to warm up, capture and replay, against
  the JAX package's jitted step on the same seeded inputs and weights, fp32,
  with the tolerances of tests/test_torch_eval.py, test_torch_train.py and
  test_torch_uniprompt.py;
- (b) ``run_validation`` over padded batches: every batch's features equal
  to the eager body's (a step that returned its static output would hand
  every batch the last batch's features), CMC and mAP as the JAX package's,
  the step kept across validations and released;
- (c) the key and warm-up decisions as plain host code: a key's third call
  captures, a short tail never evicts, new storage captures again, an
  absent optional input or another generator is another key, a step over a
  mesh of more than one rank runs eagerly and says so, and the eval cache
  keeps no model alive;
- (d) ``do_train_stage1`` over three epochs: the trailing partial batch's
  step replays in the third, and the history matches the JAX package's.

Tiny CLIP (tests/tiny.py) on one thread.
"""

import gc
import logging
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import R1mAPEvaluator as JaxEvaluator
from mpreid_tpu.engine import run_validation as jax_run_validation
from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine import uniprompt as juni
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
from mpreid_tpu.solver import make_scheduler as jax_make_scheduler
from mpreid_tpu.solver import optim as joptim
from mpreid_tpu_torch.engine import (
    R1mAPEvaluator, cached_eval_step, do_train_stage1, initial_state, make_eval_step,
    make_image_bank_step, make_stage1_step, make_text_step, make_train_step,
    release_eval_steps, run_validation,
)
from mpreid_tpu_torch.engine import processor as tproc
from mpreid_tpu_torch.engine import uniprompt as tuni
from mpreid_tpu_torch.engine.compiled import WARMUP_STEPS, CompiledStep
from mpreid_tpu_torch.engine.steps import _make_eval_body
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler
from mpreid_tpu_torch.solver import optim as toptim

from test_torch_train import _batch, _perturbed
from test_torch_uniprompt import NC, Pair, _assert_params_close, _bank, _images, _np, _t

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)


def _stats(step, captures, replays, eager):
    assert step.compiled.stats["captures"] == captures, step.compiled.stats
    assert step.compiled.stats["replays"] == replays, step.compiled.stats
    assert step.compiled.stats["eager_steps"] == eager, step.compiled.stats


# ---------------------------------------------------------------------------
# (a) each compiled step against the JAX package's jitted step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reid():
    """(jcfg, JAX ReID model, perturbed variables, tcfg, the port's twin)."""
    jcfg, jmodel, variables, tcfg, tmodel, _ = _perturbed()
    return jcfg, jmodel, variables, tcfg, tmodel.eval()


@pytest.mark.parametrize("sie_camera", [False, True])
def test_eval_step_matches_jax(reid, sie_camera):
    """Four batches (two warm-up calls, the capture's replay, one replay):
    each batch's features to 1e-4 (test_torch_uniprompt.py's forward_eval
    tolerance); under MODEL.SIE_CAMERA the camera labels are one more
    input of the step (the tiny model has no SIE table, so they change
    nothing but the key and the input buffers)."""
    jcfg, jmodel, variables, tcfg, tmodel = reid
    jcfg, tcfg = jcfg.clone(), tcfg.clone()
    jcfg.MODEL.SIE_CAMERA = tcfg.MODEL.SIE_CAMERA = sie_camera
    jstep = jsteps.make_eval_step(jmodel, jcfg)
    step = make_eval_step(tmodel, tcfg)
    for seed in range(4):
        batch = _batch(seed=seed)
        want = jstep(variables["params"], variables["batch_stats"],
                     {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(batch)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    _stats(step, captures=1, replays=2, eager=2)


@pytest.fixture(scope="module")
def pair2():
    return Pair(heads=2)


def test_image_bank_step_matches_jax(pair2):
    """Three batches: the bank features to 1e-4, ordinary tensors (no
    inference tensors: the bank enters stage 1's differentiated loss)."""
    p = pair2
    jstep = jsteps.make_image_bank_step(p.jmodel, p.jcfg)
    step = make_image_bank_step(p.tmodel, p.tcfg)
    for seed in range(3):
        images = _images(8, seed=seed)
        want = jstep(p.variables["params"], p.variables["batch_stats"],
                     {"images": jnp.asarray(images)})
        got = step({"images": images})
        assert not got.is_inference() and not got.requires_grad
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    _stats(step, captures=1, replays=1, eager=2)


@pytest.mark.parametrize("stage,with_view", [("2", False), ("1b", True)])
def test_text_step_matches_jax(pair2, stage, with_view):
    """Four full batches of 3 labels and a tail of 2: each to 1e-4
    (test_torch_uniprompt.py's get_text tolerance); the tail runs eagerly
    and leaves the full-width graph in place."""
    p = pair2
    jstep = jsteps.make_text_step(p.jmodel, stage)
    step = make_text_step(p.tmodel, stage)
    rng = np.random.default_rng(9)
    for width in (3, 3, 3, 2, 3):
        labels = rng.integers(0, NC, width).astype(np.int32)
        views = rng.integers(0, 15, width).astype(np.int32) if with_view else None
        want = jstep(p.variables["params"], p.variables["batch_stats"], jnp.asarray(labels),
                     None if views is None else jnp.asarray(views), with_view=with_view)
        got = step(_t(labels), None if views is None else _t(views))
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    _stats(step, captures=1, replays=2, eager=3)


def _nest(flat: dict, params) -> dict:
    """The JAX optimizer's moments, keyed by parameter path, as a tree of
    ``params``' shape (zeros for the frozen leaves, which have none)."""
    out = jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32), dict(params))
    for path, value in flat.items():
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return out


def test_train_step_matches_jax():
    """Three steps through both packages' make_train_step, augmentation off
    (the third captures), each from the same state: after each step the
    port's model and moments take the JAX package's parameters, statistics
    and moments in place (the same storage, so the replay reads them). Each
    step's loss to 1e-5 relative and accuracy equal, the parameters after it
    as test_torch_uniprompt.py's ``_assert_params_close`` holds them
    (0.25·lr·mult but for rounding-level gradients), the BN running
    statistics to 1e-6."""
    jcfg, jmodel, variables, tcfg, tmodel, clip = _perturbed()
    from mpreid_tpu_torch.models import from_jax_variables

    lr = 1e-3
    loss_fn, _ = make_loss(tcfg, NC)
    opt = toptim.make_optimizer(tcfg.SOLVER, tmodel, stage="baseline")
    state = initial_state(tmodel, opt)
    step = make_train_step(tmodel, tcfg, loss_fn, opt)
    jloss_fn, _ = jax_make_loss(jcfg, NC)
    jopt = joptim.make_optimizer(jcfg.SOLVER, variables["params"], stage="baseline")
    jstate = jax_initial_state(variables, jopt)
    jstep = jsteps.make_train_step(jmodel, jcfg, jloss_fn, jopt)
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        batch = _batch(seed=10 + i)
        state, metrics = step(state, batch, lr, gen)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, lr,
                           jax.random.PRNGKey(i))
        assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        assert float(metrics["acc"]) == float(jm["acc"])
        ref = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                 clip)
        _assert_params_close(tmodel, ref, lr, opt.lr_mult)
        sd = tmodel.state_dict()
        for name in ("bottleneck.running_mean", "bottleneck_proj.running_var"):
            np.testing.assert_allclose(_np(sd[name]), _np(ref[name]), atol=1e-6, rtol=0)
        tmodel.load_state_dict(ref, strict=True)
        with torch.no_grad():
            for key in ("mu", "nu"):
                moments = from_jax_variables({"params": _nest(getattr(jstate.opt_state, key),
                                                              jstate.params),
                                              "batch_stats": jstate.batch_stats}, clip)
                for name, t in getattr(state.opt_state, key).items():
                    t.copy_(moments[name])
    assert int(state.opt_state.step) == 3
    _stats(step, captures=1, replays=1, eager=2)


@pytest.mark.parametrize("stage", ["1a", "1b"])
def test_stage1_step_matches_jax(stage):
    """Four steps on bank rows through both packages' make_stage1_step: each
    loss to 1e-5 relative, the contexts after each step as
    test_torch_uniprompt.py holds them."""
    p = Pair(heads=2)
    stage_cfg = p.jcfg.SOLVER[f"STAGE{stage.upper()}"]
    lr = 1e-3
    jopt = jax_make_optimizer(stage_cfg, p.variables["params"], stage=f"stage{stage}")
    jstate = jax_initial_state(p.variables, jopt)
    jstep = jsteps.make_stage1_step(p.jmodel, p.jcfg, jopt, stage)
    opt = make_optimizer(p.tcfg.SOLVER[f"STAGE{stage.upper()}"], p.tmodel, stage=f"stage{stage}")
    state = initial_state(p.tmodel, opt)
    step = make_stage1_step(p.tmodel, p.tcfg, opt, stage)
    for i in range(4):
        feats, labels, views = _bank(8, seed=20 + i)
        jviews = jnp.asarray(views) if stage == "1b" else None
        jstate, jm = jstep(jstate, jnp.asarray(feats), jnp.asarray(labels), jviews, lr)
        state, metrics = step(state, _t(feats), _t(labels), _t(views) if stage == "1b" else None,
                              lr)
        assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
        _assert_params_close(p.tmodel, p.convert({"params": jstate.params,
                                                  "batch_stats": jstate.batch_stats}), lr)
    assert int(state.opt_state.step) == 4
    _stats(step, captures=1, replays=2, eager=2)


# ---------------------------------------------------------------------------
# (b) run_validation over padded batches
# ---------------------------------------------------------------------------

class PaddedBatcher:
    """Seeded uint8 query + gallery images with the loader's
    ``iter_sequential`` contract, the last batch padded to full width as
    ``data/loader.py`` pads it (zero images, the last record repeated)."""

    def __init__(self, n=36, batch=8, ids=6, seed=4):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, 32, 16, 3), dtype=np.uint8)
        self.pids = (np.arange(n) % ids).astype(np.int32)
        self.camids = (np.arange(n) // ids % 2).astype(np.int32)
        self.batch_size = batch

    def iter_sequential(self):
        for lo in range(0, len(self.pids), self.batch_size):
            idx = np.arange(lo, min(lo + self.batch_size, len(self.pids)))
            count, pad = len(idx), self.batch_size - len(idx)
            images = self.images[idx]
            if pad:
                images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), np.uint8)])
                idx = np.concatenate([idx, np.full(pad, idx[-1])])
            yield {"images": images, "pids": self.pids[idx], "camids": self.camids[idx],
                   "trackids": np.zeros(len(idx), np.int32), "count": count}


def test_run_validation_keeps_every_batch(reid, monkeypatch):
    """Five batches of 8 (the last holds 4 and 4 pads), twice: every batch's
    features equal to the eager body's on the same batch, CMC equal and mAP
    to 1e-6 against the JAX package's run_validation (test_torch_eval.py's
    tolerances); the second validation replays the step the first captured;
    ``release_eval_steps`` frees it."""
    jcfg, jmodel, variables, tcfg, tmodel = reid
    loader = PaddedBatcher()
    seen = []

    class Recording(R1mAPEvaluator):
        def update(self, output):
            seen.append(output[0].clone())
            super().update(output)

    monkeypatch.setattr(tproc, "R1mAPEvaluator", Recording)
    jcmc, jmap = jax_run_validation(jcfg, jmodel, variables["params"], variables["batch_stats"],
                                    loader, 12)
    body = _make_eval_body(lambda: tmodel, tcfg)
    want = [body(torch.from_numpy(b["images"]), None, None)[0][:b["count"]]
            for b in loader.iter_sequential()]
    release_eval_steps(tmodel)
    for run in range(2):
        seen.clear()
        cmc, mAP = run_validation(tcfg, tmodel, loader, 12)
        assert len(seen) == len(want) == 5
        for i, (got, w) in enumerate(zip(seen, want)):
            assert torch.equal(got, w), (run, i)
        np.testing.assert_array_equal(cmc, jcmc)
        assert abs(mAP - jmap) <= 1e-6
    step = cached_eval_step(tmodel, tcfg)
    _stats(step, captures=1, replays=8, eager=2)
    release_eval_steps(tmodel)
    assert step.compiled.graph is None and cached_eval_step(tmodel, tcfg) is not step
    release_eval_steps(tmodel)
    # JAX's evaluator on the same features gives the same metrics
    ev = JaxEvaluator(12)
    for f, b in zip(want, loader.iter_sequential()):
        ev.update((_np(f), b["pids"][:b["count"]], b["camids"][:b["count"]]))
    np.testing.assert_array_equal(ev.compute()[0], jcmc)


# ---------------------------------------------------------------------------
# (c) the key and warm-up decisions, as plain host code
# ---------------------------------------------------------------------------

def _scale(w):
    def body(x, y=None):
        return (x * w if y is None else x * w + y,)
    return body


def test_a_keys_third_call_captures_and_outputs_are_copies():
    w = torch.tensor([2.0, 3.0])
    step = CompiledStep("cpu")
    outs = [step(_scale(w), (np.full(2, float(i), np.float32),), bound=[w])[0]
            for i in range(5)]
    assert step.stats == dict(captures=1, replays=3, eager_steps=WARMUP_STEPS, pool_bytes=0)
    for i, out in enumerate(outs):
        assert torch.equal(out, torch.tensor([2.0, 3.0]) * i), i
    assert all(out is not step.static[0] for out in outs)
    w.mul_(10)  # in place: the same key, and the replay reads the new values
    assert torch.equal(step(_scale(w), (np.ones(2, np.float32),), bound=[w])[0],
                       torch.tensor([20.0, 30.0]))
    assert step.stats["captures"] == 1


def test_a_short_tail_never_evicts():
    w = torch.tensor(2.0)
    step = CompiledStep("cpu")
    for _ in range(3):
        step(_scale(w), (torch.ones(4),), bound=[w])
    held = step.key
    for _ in range(WARMUP_STEPS):  # the tail, seen fewer times than a capture needs
        assert torch.equal(step(_scale(w), (torch.ones(3),), bound=[w])[0], torch.full((3,), 2.0))
        assert step.key == held and step.stats["captures"] == 1
    step(_scale(w), (torch.ones(4),), bound=[w])
    assert step.stats == dict(captures=1, replays=2, eager_steps=2 + WARMUP_STEPS, pool_bytes=0)
    step(_scale(w), (torch.ones(3),), bound=[w])  # its third call: it captures now
    assert step.key != held and step.stats["captures"] == 2


def test_new_storage_an_optional_input_or_a_generator_is_another_key():
    w = torch.tensor(2.0)
    step = CompiledStep("cpu")
    x = (torch.ones(4),)
    for _ in range(3):
        step(_scale(w), x, bound=[w])
    w2 = w.clone()  # new storage
    for i in range(3):
        step(_scale(w2), x, bound=[w2])
        assert step.stats["captures"] == (1 if i < 2 else 2)
    assert step(_scale(w2), (torch.ones(4), torch.ones(4)), bound=[w2])[0].tolist() == [3.0] * 4
    gen = torch.Generator()
    step(_scale(w2), x, gen, bound=[w2])
    assert step.stats == dict(captures=2, replays=2, eager_steps=6, pool_bytes=0)
    step.release()  # forgets the keys: the held one warms up again
    step(_scale(w2), x, bound=[w2])
    assert step.graph is None and step.stats["eager_steps"] == 7


def test_a_step_over_a_mesh_runs_eagerly_and_says_so(reid, caplog):
    _, _, _, tcfg, tmodel = reid
    opt = toptim.make_optimizer(tcfg.SOLVER, tmodel, stage="baseline")
    mesh = types.SimpleNamespace(data=2, model=1, rank=0)
    with caplog.at_level(logging.INFO, logger="mpreid_tpu_torch"):
        step = make_train_step(tmodel, tcfg, make_loss(tcfg, NC)[0], opt, mesh=mesh)
    assert step.compiled.eager
    assert [r.getMessage() for r in caplog.records if "runs eagerly" in r.getMessage()] == [
        "The train step over the 2 x 1 mesh runs eagerly: its collectives cannot be captured "
        "into a CUDA graph"]
    assert not make_train_step(tmodel, tcfg, make_loss(tcfg, NC)[0], opt).compiled.eager
    w = torch.tensor(2.0)
    eager = CompiledStep("cpu", eager=True)
    for _ in range(4):
        eager(_scale(w), (torch.ones(2),), bound=[w])
    assert eager.stats == dict(captures=0, replays=0, eager_steps=4, pool_bytes=0)


def test_the_eval_cache_keeps_no_model_alive(reid):
    _, _, _, tcfg, _ = reid
    _, _, _, _, model, _ = _perturbed(seed=5)
    step = cached_eval_step(model, tcfg)
    assert cached_eval_step(model, tcfg) is step
    other = tcfg.clone()
    other.MODEL.SIE_CAMERA = not tcfg.MODEL.SIE_CAMERA
    assert cached_eval_step(model, other) is not step
    for _ in range(3):
        step(_batch())
    assert step.compiled.stats["captures"] == 1
    ref, cached = weakref.ref(model), len(tproc._EVAL_STEPS)
    del model
    gc.collect()
    assert ref() is None and len(tproc._EVAL_STEPS) == cached - 1


# ---------------------------------------------------------------------------
# (d) do_train_stage1: the trailing step replays from the third epoch on
# ---------------------------------------------------------------------------

def test_do_train_stage1_trailing_step_replays_in_the_third_epoch(monkeypatch):
    """20 bank rows at batch 8 over three epochs: the trailing 4 go through
    one ``make_stage1_step`` object, eager in epochs 1 and 2, captured and
    replayed in epoch 3; the loss history to 1e-5 relative of the JAX
    package's and the contexts as test_torch_uniprompt.py holds them."""
    p = Pair()
    bank = _bank(20)
    for cfg in (p.jcfg, p.tcfg):
        cfg.SOLVER.STAGE1B.MAX_EPOCHS = 3
        cfg.SOLVER.STAGE1B.BASE_LR = 1e-3
        cfg.SOLVER.STAGE1B.WARMUP_EPOCHS = 0
        cfg.OUTPUT_DIR = ""
    made = []
    real = tuni.make_stage1_step

    def spy(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(tuni, "make_stage1_step", spy)
    jopt = jax_make_optimizer(p.jcfg.SOLVER.STAGE1B, p.variables["params"], stage="stage1b")
    jvars, jhist = juni.do_train_stage1(
        p.jcfg, p.jmodel, p.variables, None, jopt,
        jax_make_scheduler(p.jcfg.SOLVER.STAGE1B, "cosine"), is_stage1b=True, bank=bank,
        stage_cfg=p.jcfg.SOLVER.STAGE1B)
    opt = make_optimizer(p.tcfg.SOLVER.STAGE1B, p.tmodel, stage="stage1b")
    state, hist = do_train_stage1(
        p.tcfg, p.tmodel, None, opt, make_scheduler(p.tcfg.SOLVER.STAGE1B, "cosine"),
        is_stage1b=True, bank=(_t(bank[0]), bank[1], bank[2]), stage_cfg=p.tcfg.SOLVER.STAGE1B)
    (step,) = made
    _stats(step, captures=1, replays=1, eager=2)
    assert step.compiled.graph is None  # released when the stage ended
    assert int(state.opt_state.step) == 9
    for h, jh in zip(hist, jhist):
        assert h["epoch"] == jh["epoch"] and abs(h["loss"] - jh["loss"]) <= 1e-5 * abs(jh["loss"])
    _assert_params_close(p.tmodel, p.convert(jvars), 1e-3)
