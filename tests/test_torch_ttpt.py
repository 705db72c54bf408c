"""The port's TTA / TTPT eval modes (engine/ttpt.py) against the JAX package's.

The Uni-Prompt model is the tiny one of ``tests/tiny.py`` (2 layers, 64
wide) in fp32 on the CPU, its weights seeded numpy values in the structure
of the JAX package's abstract init (``test_torch_moe.py::_seeded``) carried
across with ``from_jax_variables``; the images are ``make_mmmp``'s
synthetic tree (36 query and 36 gallery images), read by each package's own
loader at batch 16, so the third batch straddles the query/gallery split
and the last is padded.

Tolerances, fp32: the views and their mean exactly; features and distances
after a tower to 1e-4 absolute (tests/test_torch_model.py); rank-1, rank-5
and mAP equal; the tuner's entropy trace to 1e-5 norm-relative (the first
entry is a forward alone and reads ~4e-6 relative: the softmax at T 0.07
magnifies the towers' rounding), its tuned query features to 1e-4, its
chosen classes equal (the margins that decide them are checked to be far
above rounding first).
"""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.data import make_dataloader as jax_make_dataloader
from mpreid_tpu.engine import ttpt as jttpt
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUniPromptReID
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.data import make_dataloader
from mpreid_tpu_torch.data.synthetic import make_mmmp
from mpreid_tpu_torch.engine import (
    R1mAPEvaluator, do_inference_tta, do_inference_ttpt, make_eval_step,
)
from mpreid_tpu_torch.engine import ttpt as tttpt
from mpreid_tpu_torch.models import CLIPConfig, UniPromptReID, from_jax_variables

from test_torch_moe import _seeded
from tiny import tiny_cfg, tiny_clip_config

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

NC = 6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(root=None, **overrides):
    jcfg = tiny_cfg(**overrides)
    if root is not None:
        jcfg.DATASETS.NAMES = "mmmp"
        jcfg.DATASETS.ROOT_DIR = root
        jcfg.DATASETS.EXP_SETTING = "exp_cctv_ir_cctv_rgb"
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _models(num_classes):
    clip = tiny_clip_config()
    jmodel = JaxUniPromptReID(clip_config=clip, num_classes=num_classes, camera_num=14,
                              view_num=1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), tiny_cfg(),
                                       abstract=True))
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    tmodel = UniPromptReID(tclip, num_classes, camera_num=14, view_num=1).eval()
    tmodel.load_state_dict(from_jax_variables(variables, tclip), strict=True)
    return jmodel, variables, tmodel


@pytest.fixture(scope="module")
def mmmp(tmp_path_factory):
    root = tmp_path_factory.mktemp("mmmp_ttpt")
    make_mmmp(str(root), n_train_ids=4, n_test_ids=3, imgs_per_cam=2)
    return str(root)


@pytest.fixture(scope="module")
def env(mmmp):
    """Both packages' loaders over the tree and the twin models (the
    loader's class count)."""
    jcfg, tcfg = _cfgs(mmmp)
    jl, tl = jax_make_dataloader(jcfg), make_dataloader(tcfg)
    assert jl[3] == tl[3] == 36 and jl[3] % tcfg.TEST.IMS_PER_BATCH
    jmodel, variables, tmodel = _models(tl[4])
    return jmodel, variables, tmodel, jl[2], tl[2], tl[3]


@pytest.fixture(scope="module")
def agg():
    """Unit-norm query image features (4 × 32), tests/test_ttpt.py's."""
    rng = np.random.RandomState(3)
    a = rng.randn(4, 32).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# the views
# ---------------------------------------------------------------------------

def test_tta_views_and_aggregate_equal_jax():
    x = np.random.default_rng(0).standard_normal((3, 8, 4, 3)).astype(np.float32)
    got = tttpt.tta_views(torch.from_numpy(x))
    want = jttpt.tta_views(jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    # the views themselves as the features: the mean's summation order shows
    for g, w in zip(tttpt.tta_aggregate(lambda v: v.reshape(3, -1), torch.from_numpy(x)),
                    jttpt.tta_aggregate(lambda v: v.reshape(3, -1), jnp.asarray(x))):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_tta_flip_is_the_width_of_the_nhwc_batch():
    """eval_preprocess keeps NHWC: the h-flip reverses dimension 2."""
    x = torch.arange(2 * 2 * 3 * 3, dtype=torch.float32).reshape(2, 2, 3, 3)
    flipped = tttpt.tta_views(x)[1]
    torch.testing.assert_close(flipped[:, :, 0], x[:, :, 2], atol=0, rtol=0)
    torch.testing.assert_close(flipped[:, :, :, 1], x.flip(2)[:, :, :, 1], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# Option A
# ---------------------------------------------------------------------------

def _record(monkeypatch, module, name, into):
    """Wrap ``module.name`` so each call's arguments and result land in ``into``."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("feat_norm", ["yes", "no"])
def test_do_inference_tta_matches_jax(env, feat_norm, monkeypatch):
    """Ranks and mAP equal, query and gallery features to 1e-4 over a batch
    that straddles the split (query rows 32-35 of batch 3 get TTA, its
    gallery rows the plain feature)."""
    jmodel, variables, tmodel, jval, tval, nq = env
    jcfg, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": True, "TEST.FEAT_NORM": feat_norm})
    seen = {"jax": [], "torch": []}
    _record(monkeypatch, jttpt.R1mAPEvaluator, "compute", seen["jax"])
    _record(monkeypatch, R1mAPEvaluator, "compute", seen["torch"])
    want = jttpt.do_inference_tta(jcfg, jmodel, variables, jval, nq)
    got = do_inference_tta(tcfg, tmodel, tval, nq)
    assert got == pytest.approx(want, abs=0) and all(isinstance(r, float) for r in got)
    (_, jres), (_, tres) = seen["jax"][0], seen["torch"][0]
    assert tres[1] == pytest.approx(jres[1], abs=1e-6)  # mAP
    np.testing.assert_array_equal(tres[0], np.asarray(jres[0]))  # cmc
    for i in (5, 6):  # qf, gf
        assert tres[i].shape == np.asarray(jres[i]).shape
        np.testing.assert_allclose(tres[i], np.asarray(jres[i]), atol=1e-4, rtol=0)
    # batch 3 (rows 32-47) straddles the split: its 4 query rows are TTA
    # features, its 12 gallery rows the plain ones
    batch = next(iter(tval.iter_indices(np.arange(32, 48))))
    plain = make_eval_step(tmodel, tcfg)(batch)
    if feat_norm == "yes":
        plain = plain / torch.linalg.norm(plain, dim=1, keepdim=True)
    plain = _np(plain)
    np.testing.assert_allclose(tres[6][:12], plain[4:], atol=1e-6, rtol=0)
    assert np.abs(tres[5][32:36] - plain[:4]).max() > 1e-3


def test_do_inference_tta_reaches_the_reranked_evaluator(env):
    """TEST.RE_RANKING with TTA: the same ranks as JAX's."""
    jmodel, variables, tmodel, jval, tval, nq = env
    jcfg, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": True, "TEST.RE_RANKING": True})
    assert do_inference_tta(tcfg, tmodel, tval, nq) == pytest.approx(
        jttpt.do_inference_tta(jcfg, jmodel, variables, jval, nq), abs=0)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _tune_both(steps, agg, num_classes=NC, temp=0.07):
    jmodel, variables, tmodel = _models(num_classes)
    jcfg, tcfg = _cfgs(None, **{"TEST.TTPT.STEPS": steps, "TEST.TTPT.TEMPERATURE": temp})
    jq, je = jttpt._make_ttpt_tuner(jmodel, jcfg, num_classes)(
        variables["params"], variables["batch_stats"], jnp.asarray(agg))
    tq, te, sim = tttpt.make_ttpt_tuner(tmodel, tcfg)(torch.from_numpy(agg))
    return np.asarray(jq), np.asarray(je), _np(tq), _np(te), _np(sim), tmodel


@pytest.mark.parametrize("steps", [0, 3])
def test_tuner_matches_jax(agg, steps):
    """Entropy trace, tuned features and the chosen classes, against
    ``_make_ttpt_tuner``; STEPS 0 takes the classes from the initial context."""
    jq, je, tq, te, sim, tmodel = _tune_both(steps, agg)
    assert te.shape == je.shape == (steps,)
    if steps:
        assert np.linalg.norm(te - je) <= 1e-5 * np.linalg.norm(je)
    assert tq.shape == jq.shape == (4, 32)
    np.testing.assert_allclose(tq, jq, atol=1e-4, rtol=0)
    # the classes: sim's top-2 gaps are far above rounding, and each row is
    # the chosen class's feature in both (nearest of the initial context's
    # class features, which 3 steps at lr 1e-3 barely move)
    assert sim.shape == (4, NC)
    gap = np.sort(sim, axis=1)
    assert (gap[:, -1] - gap[:, -2]).min() > 1e-3
    with torch.no_grad():
        text = _np(tmodel.get_text(torch.arange(NC), None, "2"))
    unit = text / np.linalg.norm(text, axis=1, keepdims=True)
    np.testing.assert_array_equal(np.argmax(tq @ unit.T, axis=1), np.argmax(sim, axis=1))
    np.testing.assert_array_equal(np.argmax(jq @ unit.T, axis=1), np.argmax(sim, axis=1))
    if steps == 0:
        np.testing.assert_allclose(sim, agg @ text.T, atol=1e-6)
        np.testing.assert_allclose(tq, unit[np.argmax(sim, axis=1)], atol=1e-6)


def _contexts(steps, agg, monkeypatch):
    """(JAX's, the port's) contexts that reach ``get_text`` in a tuner run of
    ``steps``: ctx_0 .. ctx_steps, fp32 numpy. JAX's come out of its jitted
    program through an ordered debug callback in a stand-in ``get_text``, in
    a fresh trace of the tuner (``_make_ttpt_tuner_cached`` unwrapped)."""
    jmodel, variables, tmodel = _models(NC)
    jcfg, tcfg = _cfgs(None, **{"TEST.TTPT.STEPS": steps})
    seen_jax, seen_torch = [], []

    class Recording:
        @staticmethod
        def get_text(module, *args, **kwargs):
            ctx = module.variables["params"]["prompt_learner"]["ctx_generic"]
            jax.debug.callback(lambda c: seen_jax.append(np.asarray(c)), ctx, ordered=True)
            return JaxUniPromptReID.get_text(module, *args, **kwargs)

    monkeypatch.setattr(jttpt, "UniPromptReID", Recording)
    tune = jttpt._make_ttpt_tuner_cached.__wrapped__(
        jmodel, NC, jcfg.TEST.TTPT.LR, steps, jcfg.TEST.TTPT.TEMPERATURE)
    jax.block_until_ready(tune(variables["params"], variables["batch_stats"],
                               jnp.asarray(agg)))
    get_text = tmodel.get_text

    def recording(*args, ctx_generic=None, **kwargs):
        seen_torch.append(_np(ctx_generic))
        return get_text(*args, ctx_generic=ctx_generic, **kwargs)

    monkeypatch.setattr(tmodel, "get_text", recording)
    tttpt.make_ttpt_tuner(tmodel, tcfg)(torch.from_numpy(agg))
    monkeypatch.delattr(tmodel, "get_text")
    assert len(seen_jax) == len(seen_torch) == steps + 1
    return seen_jax, seen_torch


@pytest.mark.parametrize("steps", [1, 5])
def test_tuner_bias_corrections_are_jax_fp32(agg, steps, monkeypatch):
    """Each AdamW update of the tuner, recovered from the contexts as
    (ctx_{t-1} − ctx_t)/lr − wd·ctx_{t-1}, against the JAX tuner's, whose
    bias corrections 1 − b^t are fp32 (in double 1 − 0.999^t lies 0.7e-5 to
    2e-5 relative above). Step 1's update is ±(1 − b1)/bc1·√(bc2/(1 − b2))
    per element whatever the gradient, so the towers' rounding cancels:
    1e-6 norm-relative (fp32 corrections 6.1e-7, double ones 6.9e-6). Later
    updates carry the towers' rounding through the moments (~9e-6
    norm-relative either way, per element of both signs), so every step is
    held by the median of the per-element relative difference: 1e-6 (fp32
    corrections ≤ 1.2e-11, double ones 2.1e-6 to 9.2e-6)."""
    seen_jax, seen_torch = _contexts(steps, agg, monkeypatch)
    _, tcfg = _cfgs(None)
    lr, wd = tcfg.TEST.TTPT.LR, 1e-2

    def update(ctx, t):
        return (ctx[t - 1].astype(np.float64) - ctx[t]) / lr - wd * ctx[t - 1].astype(np.float64)

    want, got = update(seen_jax, 1), update(seen_torch, 1)
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    for t in range(1, steps + 1):
        want, got = update(seen_jax, t), update(seen_torch, t)
        assert abs(np.median(got / want - 1)) <= 1e-6, t


def test_tuner_is_pure(agg):
    """Every parameter and buffer bit-equal after tuning, the requires_grad
    flags as they were (one of them off), and no parameter has a gradient."""
    tmodel = _models(NC)[2]
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tmodel.image_encoder.proj.requires_grad_(False)
    try:
        flags = {n: p.requires_grad for n, p in tmodel.named_parameters()}
        _, tcfg = _cfgs(None, **{"TEST.TTPT.STEPS": 2})
        tttpt.make_ttpt_tuner(tmodel, tcfg)(torch.from_numpy(agg))
        assert {n: p.requires_grad for n, p in tmodel.named_parameters()} == flags
    finally:
        tmodel.image_encoder.proj.requires_grad_(True)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in tmodel.parameters())


def _tune(steps, agg):
    _, tcfg = _cfgs(None, **{"TEST.TTPT.STEPS": steps})
    return [_np(t) for t in tttpt.make_ttpt_tuner(_models(NC)[2], tcfg)(torch.from_numpy(agg))]


def test_tuner_entropy_descends(agg):
    """Strong descent over 8 steps (the floor wiggles by ~1e-6 once
    converged, so no step-by-step monotonicity)."""
    te = _tune(8, agg)[1]
    assert te.shape == (8,) and np.isfinite(te).all()
    assert te[1] < te[0] and te[-1] < 0.1 * te[0], te


def test_tuned_beats_untuned_on_a_rigged_gallery(agg):
    """tests/test_ttpt.py's fixture: the gallery holds each query's own image
    feature and 8 distractors; the tuned text-as-query ranks the true row
    better than the untuned one, and aligns better with its image."""
    qf0, qfT = _tune(0, agg)[0], _tune(8, agg)[0]
    assert np.abs(qfT - qf0).max() > 1e-3
    assert (np.sum(qfT * agg, axis=1) > np.sum(qf0 * agg, axis=1)).all()
    rng = np.random.RandomState(11)
    distract = rng.randn(8, 32).astype(np.float32)
    distract /= np.linalg.norm(distract, axis=1, keepdims=True)
    gallery = np.concatenate([agg, distract])

    def true_row_ranks(qf):
        order = np.argsort(1.0 - qf @ gallery.T, axis=1)
        return np.array([int(np.where(order[i] == i)[0][0]) for i in range(len(qf))])

    r0, rT = true_row_ranks(qf0), true_row_ranks(qfT)
    assert rT.sum() < r0.sum() and (rT <= r0).mean() >= 0.75, (r0, rT)


# ---------------------------------------------------------------------------
# Option B and the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tta", [True, False], ids=["tta", "no_tta"])
def test_do_inference_ttpt_matches_jax(env, tta, monkeypatch):
    """Ranks equal and the text→gallery distance matrix to 1e-4 (queries
    tuned per batch, the straddling batch included); the model untouched."""
    jmodel, variables, tmodel, jval, tval, nq = env
    jcfg, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": tta, "TEST.TTPT.ENABLED": True,
                                "TEST.TTPT.STEPS": 2})
    seen = {"jax": [], "torch": []}
    _record(monkeypatch, jttpt, "cmc_map", seen["jax"])
    _record(monkeypatch, tttpt, "cmc_map", seen["torch"])
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    want = jttpt.do_inference_ttpt(jcfg, jmodel, variables, jval, nq)
    got = do_inference_ttpt(tcfg, tmodel, tval, nq)
    assert got == pytest.approx(want, abs=0)
    (jargs, jout), (targs, tout) = seen["jax"][0], seen["torch"][0]
    assert targs[0].shape == (36, 36) == jargs[0].shape
    np.testing.assert_allclose(_np(targs[0]), np.asarray(jargs[0]), atol=1e-4, rtol=0)
    assert float(tout[1]) == pytest.approx(float(jout[1]), abs=1e-6)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_do_inference_ttpt_falls_back_to_tta(env):
    jmodel, variables, tmodel, jval, tval, nq = env
    jcfg, tcfg = _cfgs(None, **{"TEST.TTA_ENABLED": True, "TEST.TTPT.ENABLED": False})
    got = do_inference_ttpt(tcfg, tmodel, tval, nq)
    assert got == do_inference_tta(tcfg, tmodel, tval, nq)
    assert got == pytest.approx(jttpt.do_inference_ttpt(jcfg, jmodel, variables, jval, nq), abs=0)


@pytest.mark.parametrize("n_ranks", [1, 3, 4, 5, 12])
def test_rank5_clamps_to_the_last_rank_of_a_small_gallery(n_ranks):
    """cmc has min(50, gallery) entries: with fewer than 5, rank-5 is the
    last one, as JAX's _log_and_return_ranks returns it."""
    cmc = np.linspace(0.2, 1.0, n_ranks).astype(np.float32)
    logger = logging.getLogger("test_torch_ttpt")
    want = jttpt._log_and_return_ranks(logger, jnp.asarray(cmc))
    got = tttpt.log_and_return_ranks(logger, cmc)
    assert got == want
    assert got[1] == float(cmc[min(4, n_ranks - 1)])
