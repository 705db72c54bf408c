"""The TTA / TTPT eval modes' compiled steps (engine/ttpt.py) against the
JAX package's jitted programs.

On the CPU a compiled step takes the card's decisions (two eager warm-up
calls a key, a capture at the third, replays after it) with a stand-in for
the graph whose replay runs the body eagerly on the static input buffers
and copies its outputs into the static ones (engine/compiled.py), so each
step is held here over five calls with one key, warm-up, capture and
replays; the ``cuda``-marked cases of tests/test_torch_cuda.py hold the
graphs on the card. The steps, against the JAX package on the same seeded
weights and uint8 batches:

- (a) ``make_tta_query_step`` against ``ttpt.py::_tta_query_step`` with
  ``boundary`` 0, a straddling value and the full width, all on one graph;
- (b) ``make_eval_step(feat_norm=...)`` against
  ``_eval_feature_step_cached(model, feat_norm)``;
- (c) ``make_ttpt_query_step`` against the query input
  ``do_inference_ttpt`` builds from ``_eval_feature_step_cached(model)``;
- (d) ``make_ttpt_tuner`` against ``_make_ttpt_tuner_cached`` at STEPS 0
  and 3;

then the cache: the steps kept across two ``do_inference_ttpt`` calls and
not captured again, a straddling batch replaying the TTA query graph,
another LR, STEPS or TEMPERATURE giving another tuner, and
``release_eval_steps`` freeing them with no model kept alive.

The model is tests/test_torch_ttpt.py's tiny Uni-Prompt twin (2 layers, 64
wide, fp32, 6 classes). Tolerances, as there: features after a tower to
1e-4 absolute, the tuner's entropy trace to 1e-5 norm-relative, its tuned
features to 1e-4, its chosen classes equal (the margins that decide them
checked to be far above rounding first).
"""

import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import ttpt as jttpt
from mpreid_tpu.ops.augment import eval_preprocess as jax_eval_preprocess
from mpreid_tpu_torch.engine import (
    cached_eval_step, cached_tta_query_step, cached_ttpt_query_step, cached_ttpt_tuner,
    do_inference_tta, do_inference_ttpt, make_eval_step, make_tta_query_step,
    make_ttpt_query_step, make_ttpt_tuner, release_eval_steps,
)
from mpreid_tpu_torch.engine import processor as tproc
from mpreid_tpu_torch.engine.compiled import WARMUP_STEPS
from mpreid_tpu_torch.models import CLIPConfig, UniPromptReID

from test_torch_ttpt import NC, _cfgs, _models, _np, env, mmmp  # noqa: F401  (fixtures)
from tiny import tiny_clip_config

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

CALLS = 5  # two warm-up calls, the capture's replay, two replays


def _stats(step, captures, replays, eager):
    assert step.compiled.stats["captures"] == captures, step.compiled.stats
    assert step.compiled.stats["replays"] == replays, step.compiled.stats
    assert step.compiled.stats["eager_steps"] == eager, step.compiled.stats


def _batch(seed, n=8):
    """Seeded uint8 images at the tiny config's 32 × 16, with labels."""
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (n, 32, 16, 3), dtype=np.uint8),
            "pids": np.arange(n, dtype=np.int32), "camids": np.zeros(n, np.int32),
            "trackids": np.zeros(n, np.int32), "count": n}


def _jax_x(cfg, batch):
    return jax_eval_preprocess(jnp.asarray(batch["images"]), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                               std=tuple(cfg.INPUT.PIXEL_STD))


# ---------------------------------------------------------------------------
# (a)-(d): each step against the JAX package's jitted program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feat_norm", ["yes", "no"])
def test_tta_query_step_matches_jax(feat_norm):
    """Five batches at boundary 0, 3 (straddling), 8 (the full width), 5 and
    8, all one key: each batch's features to 1e-4 against
    ``_tta_query_step``; one capture serves them all, and the straddling
    batches' query rows are TTA features, their gallery rows the plain ones."""
    jmodel, variables, tmodel = _models(NC)
    jcfg, tcfg = _cfgs(None, **{"TEST.FEAT_NORM": feat_norm})
    jstep = jttpt._tta_query_step(jmodel, feat_norm == "yes")
    plain = jttpt._eval_feature_step_cached(jmodel, feat_norm == "yes")
    step = make_tta_query_step(tmodel, tcfg)
    for i, boundary in enumerate((0, 3, 8, 5, 8)):
        batch = _batch(i)
        x = _jax_x(jcfg, batch)
        want = np.asarray(jstep(variables["params"], variables["batch_stats"], x, None, None,
                                boundary))
        got = step(batch, boundary)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (8, 32 + 64)
        np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=0)
        unaided = np.asarray(plain(variables["params"], variables["batch_stats"], x, None, None))
        np.testing.assert_allclose(_np(got)[boundary:], unaided[boundary:], atol=1e-4, rtol=0)
        if boundary:
            assert np.abs(_np(got)[:boundary] - unaided[:boundary]).max() > 1e-3
    _stats(step, captures=1, replays=CALLS - WARMUP_STEPS, eager=WARMUP_STEPS)


@pytest.mark.parametrize("feat_norm", [True, False], ids=["norm", "no_norm"])
def test_plain_feature_step_matches_jax(feat_norm):
    """Five batches through ``make_eval_step(feat_norm=...)``: each to 1e-4
    against ``_eval_feature_step_cached(model, feat_norm)``, unit rows under
    the norm."""
    jmodel, variables, tmodel = _models(NC)
    jcfg, tcfg = _cfgs(None)
    jstep = jttpt._eval_feature_step_cached(jmodel, feat_norm)
    step = make_eval_step(tmodel, tcfg, feat_norm=feat_norm)
    for i in range(CALLS):
        batch = _batch(10 + i)
        want = np.asarray(jstep(variables["params"], variables["batch_stats"],
                                _jax_x(jcfg, batch), None, None))
        got = _np(step(batch))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        norms = np.linalg.norm(got, axis=1)
        assert np.allclose(norms, 1.0, atol=1e-5) == feat_norm
    _stats(step, captures=1, replays=CALLS - WARMUP_STEPS, eager=WARMUP_STEPS)


@pytest.mark.parametrize("tta", [True, False], ids=["tta", "no_tta"])
@pytest.mark.parametrize("feat_norm", ["yes", "no"])
def test_ttpt_query_step_matches_jax(tta, feat_norm):
    """Five batches through ``make_ttpt_query_step``: each to 1e-4 against
    the query input of the JAX package's ``do_inference_ttpt`` (the projected
    columns of ``_eval_feature_step_cached(model)``, averaged with the
    h-flip's under TTA, normalised under FEAT_NORM); fp32, and ordinary
    tensors (the tuner's autograd saves them)."""
    jmodel, variables, tmodel = _models(NC)
    jcfg, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": tta, "TEST.FEAT_NORM": feat_norm})
    jstep = jttpt._eval_feature_step_cached(jmodel)
    dim = jmodel.in_planes_proj
    step = make_ttpt_query_step(tmodel, tcfg)
    for i in range(CALLS):
        batch = _batch(20 + i)
        x = _jax_x(jcfg, batch)
        views = [x, x[:, :, ::-1, :]] if tta else [x]
        want = np.mean([np.asarray(jstep(variables["params"], variables["batch_stats"], v,
                                         None, None))[:, -dim:] for v in views], axis=0)
        if feat_norm == "yes":
            want = want / np.linalg.norm(want, axis=1, keepdims=True)
        got = step(batch)
        assert got.dtype == torch.float32 and not got.is_inference() and not got.requires_grad
        np.testing.assert_allclose(_np(got), want, atol=1e-4, rtol=0)
    _stats(step, captures=1, replays=CALLS - WARMUP_STEPS, eager=WARMUP_STEPS)


def _aggs(n=CALLS, rows=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.standard_normal((rows, 32)).astype(np.float32)
        out.append(a / np.linalg.norm(a, axis=1, keepdims=True))
    return out


@pytest.mark.parametrize("steps", [0, 3])
def test_tuner_matches_jax(steps):
    """Five query batches through one ``make_ttpt_tuner``: each batch's
    entropy trace to 1e-5 norm-relative, tuned features to 1e-4 and classes
    equal against ``_make_ttpt_tuner_cached``; the model untouched."""
    jmodel, variables, tmodel = _models(NC)
    jcfg, tcfg = _cfgs(None, **{"TEST.TTPT.STEPS": steps})
    jtune = jttpt._make_ttpt_tuner(jmodel, jcfg, NC)
    tune = make_ttpt_tuner(tmodel, tcfg)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with torch.no_grad():
        text = _np(tmodel.get_text(torch.arange(NC), None, "2"))
    unit = text / np.linalg.norm(text, axis=1, keepdims=True)
    for agg in _aggs():
        jq, je = (np.asarray(t) for t in jtune(variables["params"], variables["batch_stats"],
                                               jnp.asarray(agg)))
        tq, te, sim = (_np(t) for t in tune(torch.from_numpy(agg)))
        assert te.shape == je.shape == (steps,) and sim.shape == (4, NC)
        if steps:
            assert np.linalg.norm(te - je) <= 1e-5 * np.linalg.norm(je)
        np.testing.assert_allclose(tq, jq, atol=1e-4, rtol=0)
        top2 = np.sort(sim, axis=1)
        assert (top2[:, -1] - top2[:, -2]).min() > 1e-3
        # each row is its chosen class's feature in both (the nearest of the
        # initial context's class features, which 3 steps at lr 1e-3 barely move)
        np.testing.assert_array_equal(np.argmax(tq @ unit.T, axis=1), np.argmax(sim, axis=1))
        np.testing.assert_array_equal(np.argmax(jq @ unit.T, axis=1), np.argmax(sim, axis=1))
    _stats(tune, captures=1, replays=CALLS - WARMUP_STEPS, eager=WARMUP_STEPS)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in tmodel.parameters())


# ---------------------------------------------------------------------------
# the cache: kept across calls, keyed as the JAX package's lru_caches
# ---------------------------------------------------------------------------

def test_the_steps_are_kept_across_do_inference_ttpt_calls(env):
    """Two ``do_inference_ttpt`` calls (36 + 36 images at batch 16: three
    query batches, the third straddling, and three with gallery rows):
    the first captures the query input, the tuner and the plain step at
    their third calls, the second only replays; the ranks equal."""
    jmodel, variables, tmodel, jval, tval, nq = env
    _, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": True, "TEST.TTPT.ENABLED": True,
                             "TEST.TTPT.STEPS": 2})
    release_eval_steps(tmodel)
    first = do_inference_ttpt(tcfg, tmodel, tval, nq)
    steps = [cached_ttpt_query_step(tmodel, tcfg), cached_ttpt_tuner(tmodel, tcfg),
             cached_eval_step(tmodel, tcfg, feat_norm=True)]
    for step in steps:
        _stats(step, captures=1, replays=1, eager=WARMUP_STEPS)
    assert do_inference_ttpt(tcfg, tmodel, tval, nq) == first
    for step in steps:
        _stats(step, captures=1, replays=4, eager=WARMUP_STEPS)
    assert len(tproc._EVAL_STEPS[tmodel]) == 3
    release_eval_steps(tmodel)
    assert all(step.compiled.graph is None for step in steps)
    assert tmodel not in tproc._EVAL_STEPS


def test_a_straddling_batch_replays_the_tta_query_graph(env):
    """Two ``do_inference_tta`` calls: the query step's third call is the
    straddling batch (4 query rows of 16), captured with the key of the full
    ones, and the second call replays all three; the ranks as the JAX
    package's."""
    jmodel, variables, tmodel, jval, tval, nq = env
    jcfg, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": True})
    release_eval_steps(tmodel)
    want = jttpt.do_inference_tta(jcfg, jmodel, variables, jval, nq)
    for _ in range(2):
        assert do_inference_tta(tcfg, tmodel, tval, nq) == pytest.approx(want, abs=0)
    _stats(cached_tta_query_step(tmodel, tcfg), captures=1, replays=4, eager=WARMUP_STEPS)
    # two gallery-only batches a call: the plain step captured at the third
    _stats(cached_eval_step(tmodel, tcfg, feat_norm=True), captures=1, replays=2,
           eager=WARMUP_STEPS)
    release_eval_steps(tmodel)


def test_each_key_gets_its_own_step():
    """Another LR, STEPS or TEMPERATURE is another tuner, the same values the
    same one; the norm and TTA are keys of the query steps; the plain step
    with the norm fused is not the validation's eval step."""
    tmodel = _models(NC)[2]
    _, tcfg = _cfgs(None)
    tuner = cached_ttpt_tuner(tmodel, tcfg)
    assert cached_ttpt_tuner(tmodel, tcfg.clone()) is tuner
    for key, value in (("LR", 2e-3), ("STEPS", 2), ("TEMPERATURE", 0.05)):
        other = tcfg.clone()
        other.TEST.TTPT[key] = value
        assert cached_ttpt_tuner(tmodel, other) is not tuner, key
    norm_off = tcfg.clone()
    norm_off.TEST.FEAT_NORM = "no"
    assert cached_tta_query_step(tmodel, norm_off) is not cached_tta_query_step(tmodel, tcfg)
    tta_on = tcfg.clone()
    tta_on.TEST.TTA_ENABLED = not tcfg.TEST.TTA_ENABLED
    assert cached_ttpt_query_step(tmodel, tta_on) is not cached_ttpt_query_step(tmodel, tcfg)
    assert cached_eval_step(tmodel, tcfg, feat_norm=True) is not cached_eval_step(tmodel, tcfg)
    release_eval_steps(tmodel)


def test_release_frees_the_steps_and_the_cache_keeps_no_model_alive():
    """A fresh model's four steps, each captured: ``release_eval_steps``
    drops their graphs and a new call makes new steps; a dropped model is
    freed, and its steps with it."""
    clip = CLIPConfig(**dataclasses.asdict(tiny_clip_config()))
    model = UniPromptReID(clip, NC, camera_num=14, view_num=1).eval()
    _, tcfg = _cfgs(None, **{"TEST.TTPT.STEPS": 1})
    agg = torch.from_numpy(_aggs(1)[0])

    def capture_all():
        steps = [cached_tta_query_step(model, tcfg), cached_eval_step(model, tcfg, True),
                 cached_ttpt_query_step(model, tcfg), cached_ttpt_tuner(model, tcfg)]
        args = [(_batch(0), 3), (_batch(0),), (_batch(0),), (agg,)]
        for step, a in zip(steps, args):
            for _ in range(WARMUP_STEPS + 1):
                step(*a)
            assert step.compiled.stats["captures"] == 1
        return steps

    steps = capture_all()
    release_eval_steps(model)
    assert all(s.compiled.graph is None for s in steps)
    assert cached_ttpt_tuner(model, tcfg) is not steps[3]
    steps = capture_all()
    ref, cached = weakref.ref(model), len(tproc._EVAL_STEPS)
    del model
    gc.collect()
    assert ref() is None and len(tproc._EVAL_STEPS) == cached - 1
    del steps
