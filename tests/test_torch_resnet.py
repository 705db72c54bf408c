"""The RN50 backbone (A.2) of the port against the JAX package.

A tiny ModifiedResNet, (1, 1, 1, 1) bottlenecks of width 8 (attention pool
4 heads × 64) under a 2-layer, 64-wide text tower, 64×32 inputs, fp32, with
perturbed weights and BatchNorm statistics carried across by
``from_jax_variables``: the tower in eval and train mode (outputs, running
statistics after a train forward), its gradients, one baseline train step
and one Uni-Prompt stage-2a step through both packages' ``make_train_step``
(features atol 1e-4; BatchNorm statistics 1e-5 relative; parameters after
an Adam step within 0.25·lr·mult at lr 4e-5, so 1e-5 for a weight),
parameter groups, and every shipped RN50 config building its model at full
width (on the meta device, so nothing is allocated).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine import uniprompt as juni
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.models import clip_model as jclip
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUniPromptReID
from mpreid_tpu.ops import augment as jaug
from mpreid_tpu.solver import optim as joptim
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    initial_state, loss_and_grads, make_train_step, precompute_text_features,
)
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import (
    RN50, ModifiedResNet, ReIDModel, UniPromptReID, build_model, build_model_uniprompt,
    from_jax_variables, make_model, make_model_uniprompt,
)
from mpreid_tpu_torch.solver import optim as toptim

from tiny import tiny_cfg

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 8
HW = (64, 32)
TINY = dataclasses.replace(RN50, vision_layers=(1, 1, 1, 1), vision_width=8, embed_dim=32,
                           transformer_width=64, transformer_heads=1, transformer_layers=2,
                           h_resolution=4, w_resolution=2)
LR = 4e-5
RN50_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*", "cnn_*.yml")))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _perturb(variables, seed=0):
    rng = np.random.default_rng(seed)

    def params(x):
        x = np.asarray(x, np.float32)
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    def stats(path, x):
        x = np.asarray(x, np.float32)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return 0.1 * rng.standard_normal(x.shape).astype(np.float32)

    return {"params": jax.tree_util.tree_map(params, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])}


def _cfgs():
    jcfg = tiny_cfg(**{"MODEL.NAME": "RN50", "INPUT.SIZE_TRAIN": list(HW),
                       "INPUT.SIZE_TEST": list(HW), "INPUT.PROB": 0.0, "INPUT.PADDING": 0,
                       "INPUT.RE_PROB": 0.0, "SOLVER.WEIGHT_DECAY": 1e-4,
                       "SOLVER.WEIGHT_DECAY_BIAS": 1e-4, "SOLVER.BIAS_LR_FACTOR": 2,
                       "SOLVER.STAGE2.WEIGHT_DECAY": 1e-4,
                       "SOLVER.STAGE2.WEIGHT_DECAY_BIAS": 1e-4,
                       "SOLVER.STAGE2.BIAS_LR_FACTOR": 2})
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


class Pair:
    """A JAX RN50 model (baseline or Uni-Prompt) with perturbed variables and
    the port's twin loaded from them."""

    def __init__(self, uniprompt: bool):
        self.jcfg, self.tcfg = _cfgs()
        jcls, tcls = ((JaxUniPromptReID, UniPromptReID) if uniprompt
                      else (JaxReIDModel, ReIDModel))
        self.clip = jclip.CLIPConfig(**dataclasses.asdict(TINY))
        self.jmodel = jcls(clip_config=self.clip, num_classes=NC, camera_num=14, view_num=1)
        self.variables = _perturb(init_variables(self.jmodel, jax.random.PRNGKey(0), self.jcfg))
        self.tmodel = tcls(TINY, NC, camera_num=14, view_num=1).eval()
        self.load(self.variables)

    def convert(self, variables):
        return from_jax_variables(variables, TINY)

    def load(self, variables):
        self.tmodel.load_state_dict(self.convert(variables), strict=True)


@pytest.fixture(scope="module")
def base():
    return Pair(uniprompt=False)


@pytest.fixture(scope="module")
def uni():
    return Pair(uniprompt=True)


def _images(n=8, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, *HW, 3), dtype=np.uint8)


def _normalized(images, cfg):
    return np.asarray(jaug.eval_preprocess(jnp.asarray(images), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                                           std=tuple(cfg.INPUT.PIXEL_STD)))


def _tower(p, x, train):
    return p.jmodel.apply(p.variables, jnp.asarray(x),
                          method=lambda m, x: m.image_encoder(x, None, train=train),
                          mutable=["batch_stats"] if train else False)


def _assert_maps_close(got, want):
    """x3, x4 (NCHW here, NHWC in JAX) and the pooled tokens (L, B, out)."""
    for g, w, nhwc in zip(got, want[:3], (True, True, False)):
        w = np.transpose(_np(w), (0, 3, 1, 2)) if nhwc else _np(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), w, atol=1e-4, rtol=0)


def _assert_stats_close(tmodel, ref):
    sd = tmodel.state_dict()
    names = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert any(n.startswith("image_encoder.layer4.0.downsample.1") for n in names)
    for name in names:
        np.testing.assert_allclose(_np(sd[name]), _np(ref[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_from_jax_variables_carries_the_rn50_tree(base):
    """Every key of the port's RN50 model, conv kernels (kh, kw, in, out) →
    (out, in, kh, kw), BN scale/bias and batch_stats, attnpool Dense kernels
    transposed."""
    sd = base.convert(base.variables)
    assert set(sd) == set(base.tmodel.state_dict())
    jv = base.variables["params"]["visual"]
    np.testing.assert_array_equal(_np(sd["image_encoder.layer2.0.conv2.weight"]),
                                  np.transpose(jv["layer2_0"]["conv2"]["kernel"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        _np(sd["image_encoder.layer3.0.downsample.1.running_var"]),
        base.variables["batch_stats"]["visual"]["layer3_0"]["downsample_bn"]["bn"]["var"])
    np.testing.assert_array_equal(_np(sd["image_encoder.attnpool.q_proj.weight"]),
                                  jv["attnpool"]["q_proj"]["kernel"].T)
    assert isinstance(base.tmodel.image_encoder, ModifiedResNet)


def test_tower_in_eval_mode_matches_jax(base):
    x = _normalized(_images(), base.jcfg)
    with torch.no_grad():
        got = base.tmodel.image_encoder(_t(x))
    _assert_maps_close(got, _tower(base, x, train=False))
    before = {k: v.clone() for k, v in base.tmodel.state_dict().items()}
    assert all(torch.equal(v, before[k]) for k, v in base.tmodel.state_dict().items())


def test_tower_in_train_mode_and_its_running_stats_match_jax():
    p = Pair(uniprompt=False)
    x = _normalized(_images(seed=2), p.jcfg)
    want, mut = _tower(p, x, train=True)
    got = p.tmodel.image_encoder(_t(x), train=True)
    _assert_maps_close(got, want)
    stats = dict(p.variables["batch_stats"], **mut["batch_stats"])
    _assert_stats_close(p.tmodel, p.convert({"params": p.variables["params"],
                                             "batch_stats": stats}))
    assert int(p.tmodel.state_dict()["image_encoder.bn1.num_batches_tracked"]) == 1


def test_tower_gradients_match_jax(base):
    """Gradients of a fixed projection of (x3, x4, xproj) in train mode with
    respect to every tower parameter and the input."""
    x = _normalized(_images(seed=4), base.jcfg)
    rng = np.random.default_rng(5)
    shapes = [np.shape(w) for w in _tower(base, x, train=False)[:3]]
    weights = [rng.standard_normal(s).astype(np.float32) for s in shapes]

    def jloss(params, xx):
        v = {"params": params, "batch_stats": base.variables["batch_stats"]}
        outs, _ = base.jmodel.apply(v, xx, method=lambda m, x: m.image_encoder(x, None, train=True),
                                    mutable=["batch_stats"])
        return sum(jnp.sum(o * w) for o, w in zip(outs[:3], weights))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(base.variables["params"], jnp.asarray(x))
    ref = base.convert({"params": jg, "batch_stats": base.variables["batch_stats"]})
    tmodel = ReIDModel(TINY, NC, camera_num=14, view_num=1)
    tmodel.load_state_dict(base.convert(base.variables), strict=True)
    xt = _t(x).requires_grad_(True)
    outs = tmodel.image_encoder(xt, train=True)
    nchw = [np.transpose(weights[0], (0, 3, 1, 2)), np.transpose(weights[1], (0, 3, 1, 2)),
            weights[2]]
    sum((o * _t(w)).sum() for o, w in zip(outs, nchw)).backward()
    tower = dict(tmodel.image_encoder.named_parameters())
    floor = 1e-3 * max(float(np.linalg.norm(_np(ref[f"image_encoder.{n}"]))) for n in tower)
    for name, param in tower.items():
        want = _np(ref[f"image_encoder.{name}"])
        diff = float(np.linalg.norm(_np(param.grad) - want))
        assert diff <= 1e-4 * max(float(np.linalg.norm(want)), floor), name
    gx, want = _np(xt.grad), _np(jgx)
    assert float(np.linalg.norm(gx - want)) <= 1e-4 * float(np.linalg.norm(want))


def _assert_params_close(tmodel, ref, lr, mult):
    """Parameters after an Adam step to 0.25·lr·mult; an element whose
    gradient is within rounding of zero may step the other way (up to one
    element in 10⁴ of a leaf, and one in any leaf, by up to 2·lr·mult)."""
    for name, param in tmodel.named_parameters():
        unit = lr * mult.get(name, 1.0)
        err = np.abs(_np(param) - _np(ref[name]))
        assert (err > 0.25 * unit).sum() <= max(1, err.size // 10_000), (
            name, float(err.max()), unit)
        assert float(err.max()) <= 2 * unit, (name, float(err.max()), unit)


def _batch(seed=3):
    return {"images": _images(seed=seed), "pids": np.repeat(np.arange(2), 4).astype(np.int32),
            "camids": np.zeros(8, np.int32), "trackids": np.zeros(8, np.int32)}


def test_baseline_train_step_matches_jax():
    """One ``make_train_step`` of each package from the same weights,
    augmentation off: loss, accuracy, every gradient, the RN50 BatchNorms'
    and BNNecks' running statistics, and every parameter after."""
    p = Pair(uniprompt=False)
    batch = _batch()
    x = jnp.asarray(_normalized(batch["images"], p.jcfg))
    target = jnp.asarray(batch["pids"])
    jloss_fn, _ = jax_make_loss(p.jcfg, NC)

    def inner(params):
        out, mut = p.jmodel.apply({"params": params, "batch_stats": p.variables["batch_stats"]},
                                  x, target, train=True, mutable=["batch_stats"])
        return jloss_fn(out["scores"], out["feats"], target, None), mut

    (jloss, jmut), jg = jax.value_and_grad(inner, has_aux=True)(p.variables["params"])
    ref_g = p.convert({"params": jg, "batch_stats": jmut["batch_stats"]})
    loss_fn, _ = make_loss(p.tcfg, NC)
    opt = toptim.make_optimizer(p.tcfg.SOLVER, p.tmodel, stage="baseline")
    loss, _, grads, _ = loss_and_grads(p.tmodel, p.tcfg, loss_fn, opt, _t(np.asarray(x)),
                                       _t(batch["pids"]).long())
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    floor = 1e-3 * max(float(np.linalg.norm(_np(ref_g[n]))) for n in grads)
    for name, g in grads.items():
        diff = float(np.linalg.norm(_np(g) - _np(ref_g[name])))
        assert diff <= 1e-4 * max(float(np.linalg.norm(_np(ref_g[name]))), floor), name
    _assert_stats_close(p.tmodel, ref_g)

    p.load(p.variables)
    state = initial_state(p.tmodel, opt)
    step = make_train_step(p.tmodel, p.tcfg, loss_fn, opt)
    state, metrics = step(state, batch, LR, torch.Generator().manual_seed(0))
    jopt = joptim.make_optimizer(p.jcfg.SOLVER, p.variables["params"], stage="baseline")
    jstate, jm = jsteps.make_train_step(p.jmodel, p.jcfg, jloss_fn, jopt)(
        jax_initial_state(p.variables, jopt), {k: jnp.asarray(v) for k, v in batch.items()},
        LR, jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jloss))
    assert float(metrics["acc"]) == float(jm["acc"])
    ref_p = p.convert({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_params_close(p.tmodel, ref_p, LR, opt.lr_mult)
    _assert_stats_close(p.tmodel, ref_p)


def test_stage2a_step_matches_jax():
    """One Uni-Prompt stage-2a step (ID + triplet + i2t against the text
    features of every class) through both packages: the text tower and the
    prompt learner stay frozen, the RN50 tower and its BatchNorms train."""
    p = Pair(uniprompt=True)
    batch = _batch(seed=6)
    text = juni.precompute_text_features(p.jcfg, p.jmodel, p.variables, NC)
    text_t = precompute_text_features(p.tcfg, p.tmodel, NC)
    np.testing.assert_allclose(_np(text_t), _np(text), atol=1e-5, rtol=0)
    jloss_fn, _ = jax_make_loss(p.jcfg, NC)
    loss_fn, _ = make_loss(p.tcfg, NC)
    opt = toptim.make_optimizer(p.tcfg.SOLVER.STAGE2, p.tmodel, stage="stage2a")
    assert any(n.startswith("image_encoder.layer1.0.bn1") for n, f in opt.trainable.items() if f)
    state = initial_state(p.tmodel, opt)
    step = make_train_step(p.tmodel, p.tcfg, loss_fn, opt, uniprompt=True, text_features=text_t)
    state, metrics = step(state, batch, LR, torch.Generator().manual_seed(0))
    jopt = joptim.make_optimizer(p.jcfg.SOLVER.STAGE2, p.variables["params"], stage="stage2a")
    jstate, jm = jsteps.make_train_step(p.jmodel, p.jcfg, jloss_fn, jopt, uniprompt=True,
                                        text_features=jnp.asarray(text))(
        jax_initial_state(p.variables, jopt), {k: jnp.asarray(v) for k, v in batch.items()},
        LR, jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert float(metrics["acc"]) == float(jm["acc"])
    ref_p = p.convert({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_params_close(p.tmodel, ref_p, LR, opt.lr_mult)
    _assert_stats_close(p.tmodel, ref_p)
    before = p.convert(p.variables)
    for name, param in p.tmodel.named_parameters():
        if name.startswith(("text_encoder.", "prompt_learner.")):
            np.testing.assert_array_equal(_np(param), _np(before[name]), err_msg=name)


def test_uniprompt_image_forwards_match_jax(uni):
    """get_image (the bank: running statistics), get_image_vp and
    get_more_image pick the RN50 pool's tokens from (L, B, out)."""
    x = _normalized(_images(seed=7), uni.jcfg)
    for name in ("get_image", "get_image_vp", "get_more_image"):
        want = uni.jmodel.apply(uni.variables, jnp.asarray(x),
                                method=getattr(JaxUniPromptReID, name))
        with torch.no_grad():
            got = getattr(uni.tmodel, name)(_t(x))
        for g, w in zip(*((got, want) if name == "get_more_image" else ([got], [want]))):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("stage", ["baseline", "stage2a", "stage2b"])
def test_groups_and_trainable_match_jax_on_the_rn50_tree(uni, stage):
    """lr multiplier, weight decay and trainable flag of every RN50 leaf
    (BatchNorm weights and biases, conv kernels, the pool's projections)
    carried to torch names, against the port's decisions."""
    solver = uni.jcfg.SOLVER.STAGE2
    params = uni.variables["params"]
    jmult, jwd = joptim.group_trees(params, solver)
    jtrain = joptim.stage_trainable(params, stage)
    tmult, twd = toptim.group_trees(uni.tmodel, solver)
    ttrain = toptim.stage_trainable(uni.tmodel, stage)
    for jtree, tdict in ((jmult, tmult), (jwd, twd), (jtrain, ttrain)):
        filled = jax.tree_util.tree_map(lambda x, v: np.full(np.shape(x), float(v), np.float32),
                                        params, jtree)
        carried = uni.convert({"params": filled, "batch_stats": uni.variables["batch_stats"]})
        for name, value in tdict.items():
            assert np.unique(_np(carried[name])).tolist() == [float(np.float32(value))], name
    assert tmult["image_encoder.layer1.0.bn1.bias"] == 2.0
    assert tmult["image_encoder.layer1.0.bn1.weight"] == 1.0


@pytest.mark.parametrize("path", RN50_CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_rn50_config_builds_its_model(path):
    """The six shipped RN50 configs build their model at the full RN50 width
    ((3, 4, 6, 3) bottlenecks of width 64, a 32-head pool of 2048, embed
    1024, the 12 × 512 text tower for Uni-Prompt), and its eval feature is
    3,072-d; on the meta device (shapes only)."""
    cfg = get_default_cfg()
    cfg.merge_from_file(path)
    cfg.MODEL.DEVICE = "cpu"
    uniprompt = not path.endswith("cnn_base.yml")
    with torch.device("meta"):
        build = build_model_uniprompt if uniprompt else build_model
        model = build(cfg, num_class=10, camera_num=6, view_num=1)
        h, w = cfg.INPUT.SIZE_TRAIN
        out = model.forward_train(torch.empty(2, h, w, 3), torch.zeros(2, dtype=torch.long))
        feat = model.forward_eval(torch.empty(2, h, w, 3))
    tower = model.image_encoder
    assert isinstance(tower, ModifiedResNet) and model.in_planes == 2048
    assert [len(getattr(tower, f"layer{i}")) for i in range(1, 5)] == [3, 4, 6, 3]
    assert tower.attnpool.num_heads == 32
    assert tuple(tower.attnpool.positional_embedding.shape) == ((h // 16) * (w // 16) + 1, 2048)
    assert [f.shape[-1] for f in out["feats"]] == [1024, 2048, 1024]
    assert tuple(feat.shape) == (2, 3072)
    assert hasattr(model, "text_encoder") == uniprompt
    assert len(RN50_CONFIGS) == 6


@pytest.mark.parametrize("entry", ["train", "train_uniprompt"])
def test_rn50_entries_run_on_the_card_unless_asked_for_the_cpu(monkeypatch, entry):
    """With no card and no ``MODEL.DEVICE cpu``, the RN50 configs' entry
    points and their model refuse to fall back to the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = "cnn_base.yml" if entry == "train" else "cnn_clipreid.yml"
    module = importlib.import_module(f"mpreid_tpu_torch.{entry}")
    with pytest.raises(RuntimeError, match="none is available"):
        module.main(["--config_file", os.path.join(REPO, "configs", "person", config)])
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "person", config))
    with torch.device("meta"), pytest.raises(RuntimeError, match="none is available"):
        build = make_model if entry == "train" else make_model_uniprompt
        build(cfg, 4, 2, 1)
