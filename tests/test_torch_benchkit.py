"""The port's measured programs (mpreid_tpu_torch/utils/benchkit.py) against
the JAX package's benchkit, on the CPU.

- The port's counterpart of every case of tests/test_benchkit.py, on the
  port alone (``debug_tiny``, 64×32, 12 classes): each builder driven end
  to end, the step counters after the windows ``best_of`` ran, and the
  compiled runners' warm-up, capture and replays (on the CPU a capture is
  ``engine/compiled.py``'s stand-in, so the decisions run but no graph).
- The port's programs against the JAX benchkit's on the same weights (the
  JAX variable trees from an abstract init filled with seeded numpy values,
  tests/test_torch_moe.py's ``_seeded``, carried across with
  ``from_jax_variables``) and the same ``np.random.RandomState`` draws, in
  fp32, augmentation off: the draws byte for byte; stage-1a and 1b window
  losses to 1e-4 relative (as tests/test_torch_compiled_epoch.py) and the
  contexts after; the stage-2a window's parameters as
  tests/test_torch_uniprompt.py holds them after Adam and the next step's
  loss to 1e-4 relative; the eval and TTA scans' values to 1e-5 of the
  magnitude of the features they sum (Σ|f|: each feature to 1e-5 relative
  bounds the sum so; the sum cancels, and relative to the value itself the
  two frameworks' summation orders alone come near 1e-5);
  ``do_inference_tta`` over ``SyntheticValLoader``: CMC equal, mAP to 1e-6;
  the RN50 baseline harness and eval scan at tests/test_torch_resnet.py's
  tiny RN50 (both factories' RN50 entry monkeypatched for the test).
- Builders asked for the card on a host without one raise.

One intra-op thread (tests/cpu_threads.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import ttpt as jttpt
from mpreid_tpu.models import factory as jfactory
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.utils import benchkit as jbk
from mpreid_tpu_torch.engine import do_inference_tta
from mpreid_tpu_torch.engine import ttpt as tttpt
from mpreid_tpu_torch.models import factory as tfactory
from mpreid_tpu_torch.models import from_jax_variables
from mpreid_tpu_torch.ops.augment import eval_preprocess
from mpreid_tpu_torch.utils import benchkit as bk

from test_torch_moe import _seeded
from test_torch_resnet import TINY as TINY_RN50
from test_torch_uniprompt import _assert_params_close

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

NC = 12
HW = (64, 32)
LOSS_RTOL = 1e-4
SCAN_RTOL = 1e-5
MAP_ATOL = 1e-6
AUG_OFF = {"PROB": 0.0, "PADDING": 0, "RE_PROB": 0.0}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def _assert_scan_close(run, got: float, want: float) -> None:
    """``got`` within SCAN_RTOL of Σ|f| of ``want``: f every feature element
    the window's forwards sum (the carry stays 0, so each forward reads the
    same images)."""
    with torch.no_grad():
        f = run.features(eval_preprocess(run.images, mean=run.mean, std=run.std))
    mass = run.iters * float(f.abs().sum())
    assert abs(got - want) <= SCAN_RTOL * mass, (got, want, mass)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_benchkit.py, on the port alone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_env():
    return bk.uniprompt_env(num_classes=NC, camera_num=4, view_num=1, size=HW,
                            debug_tiny=True, device="cpu")


def test_stage1_harness_and_window(tiny_env):
    cfg, model = tiny_env
    h = bk.stage1_harness(cfg, model, stage="1a", iters=3, batch=8, num_classes=NC,
                          embed_dim=model.clip_config.embed_dim)
    run = bk.epoch_window(h)
    dt = bk.best_of(run, windows=2, warmup=1)
    assert dt > 0
    assert int(h["state"].opt_state.step) == 3 * 3  # 3 windows × 3 iters
    # two eager rows and a capture in the first window, replays after
    assert {k: v for k, v in bk.graph_stats(h).items() if k != "capture_seconds"} == dict(
        captures=1, replays=7, eager_steps=2, pool_bytes=0)
    assert h["losses"].shape == (3,) and torch.isfinite(h["losses"]).all()
    assert h["state"].model is not model  # the harness trains a copy


def test_stage1b_random_views(tiny_env):
    cfg, model = tiny_env
    h = bk.stage1_harness(cfg, model, stage="1b", iters=2, batch=4, num_classes=NC,
                          embed_dim=model.clip_config.embed_dim, random_views=True)
    assert int(h["views"].max()) > 0  # real view labels
    assert bk.best_of(bk.epoch_window(h), windows=1) > 0


def test_stage2_harness_and_step_window(tiny_env):
    cfg, model = tiny_env
    h = bk.stage2_harness(cfg, model, num_classes=NC, batch=8,
                          embed_dim=model.clip_config.embed_dim)
    assert tuple(h["batch"]["images"].shape) == (8, *HW, 3)
    run = bk.step_window(h, iters=2)
    assert run.warmup == 2  # calls 1-2 eager, call 3 captures: windows 3 and 4 only replay
    dt = bk.best_of(run, windows=2)
    assert dt > 0
    assert int(h["state"].opt_state.step) == (2 + 2) * 2
    stats = bk.graph_stats(h)
    assert (stats["eager_steps"], stats["captures"], stats["replays"]) == (2, 1, 6)
    with pytest.raises(ValueError, match="not replays"):
        bk.best_of(bk.step_window(h, iters=1), windows=1, warmup=2)


def test_eval_scan(tiny_env):
    cfg, model = tiny_env
    run = bk.make_eval_scan(cfg, model, batch=4, iters=3)
    v = run()
    assert np.isfinite(v)
    assert bk.best_of(bk.timed(run), windows=1) > 0
    # the compiled forward's window equals the eager one bit for bit
    assert run() == v == run.eager()
    assert bk.graph_stats(run)["captures"] == 1


def test_rn50_env_baseline_harness(monkeypatch):
    monkeypatch.setitem(tfactory._BASE_CONFIGS, "RN50", TINY_RN50)
    cfg, model = bk.rn50_env(num_classes=NC, size=HW, debug_tiny=True, device="cpu")
    h = bk.baseline_harness(cfg, model, num_classes=NC, batch=8)
    run = bk.step_window(h, iters=1)
    assert bk.best_of(run, windows=1) > 0
    assert int(h["state"].opt_state.step) == run.warmup + 1 == 4
    run = bk.make_eval_scan(cfg, model, batch=4, iters=2)
    assert np.isfinite(run())


def test_release_frees_what_a_harness_and_a_window_hold(tiny_env):
    cfg, model = tiny_env
    h = bk.stage2_harness(cfg, model, num_classes=NC, batch=8,
                          embed_dim=model.clip_config.embed_dim)
    run = bk.step_window(h, iters=3)
    run()
    step = h["step"]
    assert step.compiled.graph is not None
    bk.release(h)
    assert h == {} and step.compiled.graph is None
    scan = bk.make_tta_scan(cfg, model, batch=4, iters=3)
    scan()
    bk.release(scan)
    assert scan.images is None and scan.compiled.graph is None


def test_model_builders_take_the_jax_settings():
    """``*_model`` builds the JAX benchkit's config and a model of the same
    shapes, on the meta device."""
    for jfn, tfn, kw in ((jbk.uniprompt_model, bk.uniprompt_model,
                          dict(num_classes=NC, camera_num=4, view_num=1)),
                         (jbk.rn50_model, bk.rn50_model, dict(num_classes=NC))):
        jcfg, jmodel = jfn(size=HW, debug_tiny=True, **kw)
        tcfg, tmodel = tfn(size=HW, debug_tiny=True, **kw)
        for key in ("MODEL.NAME", "MODEL.DEBUG_TINY", "MODEL.ID_LOSS_WEIGHT",
                    "INPUT.SIZE_TRAIN", "INPUT.SIZE_TEST", "DATALOADER.SAMPLER",
                    "TPU.COMPUTE_DTYPE", "SOLVER.STAGE1A.OPTIMIZER_NAME",
                    "SOLVER.STAGE2.BASE_LR", "SOLVER.OPTIMIZER_NAME"):
            sec, name = key.split(".", 1)
            jv, tv = jcfg[sec], tcfg[sec]
            for part in name.split("."):
                jv, tv = jv[part], tv[part]
            assert tv == jv, key
        assert dataclasses.asdict(tmodel.clip_config) == dataclasses.asdict(jmodel.clip_config)
        assert next(tmodel.parameters()).device.type == "meta"
        assert tcfg.MODEL.DEVICE == "tpu"  # the card, through utils/device.py


def test_builders_asked_for_the_card_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is available"):
        bk.uniprompt_env(num_classes=NC, size=HW, debug_tiny=True)
    monkeypatch.setitem(tfactory._BASE_CONFIGS, "RN50", TINY_RN50)
    with pytest.raises(RuntimeError, match="none is available"):
        bk.rn50_env(num_classes=NC, size=HW)
    cfg, _ = bk.uniprompt_model(num_classes=NC, size=HW, debug_tiny=True)
    with pytest.raises(RuntimeError, match="none is available"):
        bk.SyntheticValLoader(cfg, 1, 1, 4)
    with pytest.raises(RuntimeError, match="none is available"):
        bk.synthetic_train_batch(4, NC, HW)


# ---------------------------------------------------------------------------
# against the JAX benchkit, on the same weights and draws
# ---------------------------------------------------------------------------

def _fp32(cfg):
    cfg.TPU.COMPUTE_DTYPE = "float32"
    for k, v in AUG_OFF.items():
        cfg.INPUT[k] = v
    return cfg


class UniPair:
    """The JAX benchkit's Uni-Prompt bench config in fp32, its model with
    seeded variables, and the port's model of the port's bench config
    carrying them."""

    def __init__(self):
        jcfg, _ = jbk.uniprompt_model(num_classes=NC, camera_num=4, view_num=1, size=HW,
                                      debug_tiny=True)
        self.jcfg = _fp32(jcfg)
        self.jmodel = jfactory.make_model_uniprompt(self.jcfg, NC, 4, 1)
        self.variables = _seeded(init_variables(self.jmodel, jax.random.PRNGKey(0), self.jcfg,
                                                abstract=True))
        tcfg, _ = bk.uniprompt_model(num_classes=NC, camera_num=4, view_num=1, size=HW,
                                     debug_tiny=True, device="cpu")
        self.tcfg = _fp32(tcfg)
        self.tmodel = tfactory.build_model_uniprompt(self.tcfg, NC, 4, 1).eval()
        self.tmodel.load_state_dict(self.convert(self.variables), strict=True)

    def convert(self, variables):
        return from_jax_variables(variables, self.tmodel.clip_config)


@pytest.fixture(scope="module")
def uni():
    return UniPair()


@pytest.mark.parametrize("stage", ["1a", "1b"])
def test_stage1_window_matches_jax(uni, stage):
    before = {k: v.clone() for k, v in uni.tmodel.state_dict().items()}
    kw = dict(stage=stage, iters=3, batch=8, num_classes=NC, embed_dim=32,
              random_views=stage == "1b")
    jh = jbk.stage1_harness(uni.jcfg, uni.jmodel, uni.variables,
                            rng=np.random.RandomState(5), **kw)
    h = bk.stage1_harness(uni.tcfg, uni.tmodel, rng=np.random.RandomState(5), **kw)
    for key in ("bank", "labels", "views", "perm"):
        np.testing.assert_array_equal(h[key].numpy(), np.asarray(jh[key]), err_msg=key)
    lr = 3.5e-4
    bk.epoch_window(h, lr)()
    jstate, jlosses = jh["epoch_fn"](jh["state"], jh["bank"], jh["labels"], jh["views"],
                                     jh["perm"], lr)  # the JAX window's program
    np.testing.assert_allclose(_np(h["losses"]), _np(jlosses), rtol=LOSS_RTOL, atol=0)
    _assert_params_close(h["state"].model, uni.convert(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}), lr)
    for k, v in uni.tmodel.state_dict().items():  # the caller's model is left as it was
        assert torch.equal(v, before[k]), k


def test_stage2_window_matches_jax(uni):
    kw = dict(num_classes=NC, batch=8, embed_dim=32)
    jh = jbk.stage2_harness(uni.jcfg, uni.jmodel, uni.variables,
                            rng=np.random.RandomState(6), **kw)
    h = bk.stage2_harness(uni.tcfg, uni.tmodel, rng=np.random.RandomState(6), **kw)
    np.testing.assert_array_equal(_np(h["text_features"]), np.asarray(jh["text_features"]))
    for key, value in h["batch"].items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jh["batch"][key]), err_msg=key)
    lr = 1e-3
    bk.step_window(h, iters=3, lr=lr)()  # eager, eager, the capture's first replay
    jbk.step_window(jh, iters=3, lr=lr)()
    assert int(h["state"].opt_state.step) == int(jh["state"].opt_state.step) == 3
    _assert_params_close(h["state"].model, uni.convert(
        {"params": jh["state"].params, "batch_stats": jh["state"].batch_stats}), lr,
        h["opt"].lr_mult)
    # the next step's loss reads every parameter and BN statistic the window left
    _, m = h["step"](h["state"], h["batch"], lr, h["gen"])
    _, jm = jh["step"](jh["state"], jh["batch"], lr, jh["key"])
    assert _rel(m["loss"], jm["loss"]) <= LOSS_RTOL


@pytest.mark.parametrize("which", ["eval", "tta"])
def test_scans_match_jax(uni, which):
    jmake, tmake = {"eval": (jbk.make_eval_scan, bk.make_eval_scan),
                    "tta": (jbk.make_tta_scan, bk.make_tta_scan)}[which]
    want = jmake(uni.jcfg, uni.jmodel, uni.variables["params"], uni.variables["batch_stats"],
                 batch=4, iters=3, rng=np.random.RandomState(7))()
    run = tmake(uni.tcfg, uni.tmodel, batch=4, iters=3, rng=np.random.RandomState(7))
    got = [run(), run()]
    assert got[0] == got[1] == run.eager()
    _assert_scan_close(run, got[0], want)


def _recording(cls, seen: list):
    class Recording(cls):
        def compute(self):
            out = super().compute()
            seen.append(out)
            return out

    return Recording


def test_val_loader_and_tta_inference_match_jax(uni, monkeypatch):
    jl = jbk.SyntheticValLoader(uni.jcfg, 2, 2, 8, rng=np.random.RandomState(3))
    tl = bk.SyntheticValLoader(uni.tcfg, 2, 2, 8, rng=np.random.RandomState(3))
    assert (tl.num_query, tl.total) == (jl.num_query, jl.total) == (16, 32)
    for tb, jb in zip(tl.iter_sequential(), jl.iter_sequential(), strict=True):
        assert tb["images"].dtype == torch.uint8 and tb["images"].device.type == "cpu"
        np.testing.assert_array_equal(tb["images"].numpy(), np.asarray(jb["images"]))
        for key in ("pids", "camids", "trackids"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        assert tb["count"] == jb["count"]
    seen_j, seen_t = [], []
    monkeypatch.setattr(jttpt, "R1mAPEvaluator", _recording(jttpt.R1mAPEvaluator, seen_j))
    monkeypatch.setattr(tttpt, "R1mAPEvaluator", _recording(tttpt.R1mAPEvaluator, seen_t))
    want = jttpt.do_inference_tta(uni.jcfg, uni.jmodel, uni.variables, jl, jl.num_query)
    got = do_inference_tta(uni.tcfg, uni.tmodel, tl, tl.num_query)
    (jcmc, jmap, *_), (tcmc, tmap, *_) = seen_j[0], seen_t[0]
    np.testing.assert_array_equal(tcmc, np.asarray(jcmc))
    assert abs(tmap - float(jmap)) <= MAP_ATOL
    assert got == pytest.approx(want, abs=0)


def test_rn50_baseline_harness_and_eval_scan_match_jax(monkeypatch):
    monkeypatch.setitem(jfactory._BASE_CONFIGS, "RN50",
                        jfactory.RN50.__class__(**dataclasses.asdict(TINY_RN50)))
    monkeypatch.setitem(tfactory._BASE_CONFIGS, "RN50", TINY_RN50)
    jcfg, _ = jbk.rn50_model(num_classes=NC, size=HW)
    jcfg = _fp32(jcfg)
    jmodel = jfactory.make_model(jcfg, NC, 14, 1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(1), jcfg, abstract=True))
    tcfg, _ = bk.rn50_model(num_classes=NC, size=HW, device="cpu")
    tcfg = _fp32(tcfg)
    tmodel = tfactory.build_model(tcfg, NC, 14, 1).eval()
    tmodel.load_state_dict(from_jax_variables(variables, tmodel.clip_config), strict=True)

    want = jbk.make_eval_scan(jcfg, jmodel, variables["params"], variables["batch_stats"],
                              batch=4, iters=2, rng=np.random.RandomState(9))()
    run = bk.make_eval_scan(tcfg, tmodel, batch=4, iters=2, rng=np.random.RandomState(9))
    _assert_scan_close(run, run(), want)

    jh = jbk.baseline_harness(jcfg, jmodel, variables, num_classes=NC, batch=8,
                              rng=np.random.RandomState(8))
    h = bk.baseline_harness(tcfg, tmodel, num_classes=NC, batch=8,
                            rng=np.random.RandomState(8))
    assert h["text_features"] is None
    for key, value in h["batch"].items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jh["batch"][key]), err_msg=key)
    lr = 4e-5
    bk.step_window(h, iters=2, lr=lr)()
    jbk.step_window(jh, iters=2, lr=lr)()
    _assert_params_close(h["state"].model, from_jax_variables(
        {"params": jh["state"].params, "batch_stats": jh["state"].batch_stats},
        tmodel.clip_config), lr, h["opt"].lr_mult)
    _, m = h["step"](h["state"], h["batch"], lr, h["gen"])
    _, jm = jh["step"](jh["state"], jh["batch"], lr, jh["key"])
    assert _rel(m["loss"], jm["loss"]) <= LOSS_RTOL
