"""The port's training slice (mpreid_tpu_torch) against the JAX package's.

Every piece of the baseline train path is held against its JAX twin on the
same inputs, made from numpy seeds: the linear layers' gradients, BNNeck in
train mode, ``forward_train``, the losses, the parameter groups, the
optimizers, the fused Adam leaf, the schedules, the augmentation (fed the
JAX package's own random draws), one whole train step from the same weights
(augmentation off), and the loops (``do_train``, checkpoints, resume, the
``python -m mpreid_tpu_torch.train`` CLI). The CLIP is the tiny one of
``tests/tiny.py`` (2 layers, 64 wide) in fp32 on the CPU.

Tolerances, fp32 unless said: values to 1e-5 relative (the two frameworks
sum in other orders); gradients per leaf to a norm-relative 1e-4, with the
reference norm floored at 1e-3 of the largest leaf's (a leaf whose exact
gradient is zero, such as ``ln_post.bias`` under the BNNeck or the k part
of ``in_proj_bias`` under the softmax, carries only rounding noise); BN
running statistics to 1e-6; parameters after an Adam step to 0.25·lr·mult
(the first Adam step is lr·g/(|g|+eps), so an element whose gradient is
near eps moves by a fraction of lr that rounding can change).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.data.synthetic import make_market1501
from mpreid_tpu.engine.steps import make_train_step as jax_make_train_step
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import center as jcenter
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.losses import softmax as jsoftmax
from mpreid_tpu.losses import triplet as jtriplet
from mpreid_tpu.models.layers import BNNeck as JaxBNNeck
from mpreid_tpu.models.layers import linear_bias_act
from mpreid_tpu.ops import augment as jaug
from mpreid_tpu.ops.adam_kernel import fused_adam_leaf as jax_fused_adam_leaf
from mpreid_tpu.solver import optim as joptim
from mpreid_tpu.solver import schedules as jsched
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    do_train, initial_state, loss_and_grads, make_train_step,
)
from mpreid_tpu_torch.losses import center as tcenter
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.losses import softmax as tsoftmax
from mpreid_tpu_torch.losses import triplet as ttriplet
from mpreid_tpu_torch.models import CLIPConfig, ReIDModel, from_jax_variables, load_param
from mpreid_tpu_torch.models.layers import BNNeck, Linear, linear_f32acc
from mpreid_tpu_torch.ops import adam as tadam
from mpreid_tpu_torch.ops import augment as taug
from mpreid_tpu_torch.solver import optim as toptim
from mpreid_tpu_torch.solver import schedules as tsched
from mpreid_tpu_torch.utils.checkpoint import load_checkpoint, restore_state

from tiny import tiny_cfg, tiny_model

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("accum_f32", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
def test_linear_gradients_match_jax_vjp(accum_f32, with_bias):
    """linear_f32acc (accum_f32) and Linear (the MLP's form) in fp32: output
    and the gradients of x, W and b against jax.vjp of linear_bias_act."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((24, 16)).astype(np.float32) * 0.3  # (out, in)
    b = rng.standard_normal(24).astype(np.float32)
    dy = rng.standard_normal((3, 5, 24)).astype(np.float32)
    jb = jnp.asarray(b) if with_bias else jnp.zeros(24, jnp.float32)
    want, vjp = jax.vjp(lambda x_, k_, b_: linear_bias_act(x_, k_, b_, jnp.float32, accum_f32),
                        jnp.asarray(x), jnp.asarray(w.T), jb)
    jdx, jdk, jdb = vjp(jnp.asarray(dy))

    tx = _t(x).requires_grad_(True)
    if accum_f32:
        tw = _t(w).requires_grad_(True)
        tb = _t(b).requires_grad_(True) if with_bias else None
        got = linear_f32acc(tx, tw, tb, torch.float32)
    else:
        layer = Linear(16, 24, bias=with_bias)
        with torch.no_grad():
            layer.weight.copy_(_t(w))
            if with_bias:
                layer.bias.copy_(_t(b))
        tw, tb = layer.weight, layer.bias
        got = layer(tx)
    got.backward(_t(dy))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tw.grad), _np(jdk).T, rtol=1e-5, atol=1e-5)
    if with_bias:
        np.testing.assert_allclose(_np(tb.grad), _np(jdb), rtol=1e-5, atol=1e-5)


def test_linear_bf16_rounding_points():
    """bf16 on the CPU: the forward is the fp32-summed product rounded once;
    dx and dW are fp32 sums rounded to bf16; dW reaches the fp32 parameter
    as fp32; db is the fp32 sum of dy."""
    rng = np.random.default_rng(1)
    x = _t(rng.standard_normal((4, 7, 32)).astype(np.float32)).bfloat16().requires_grad_(True)
    w = _t(rng.standard_normal((16, 32)).astype(np.float32)).requires_grad_(True)
    b = _t(rng.standard_normal(16).astype(np.float32)).requires_grad_(True)
    dy = _t(rng.standard_normal((4, 7, 16)).astype(np.float32)).bfloat16()
    y = linear_f32acc(x, w, b, torch.bfloat16)
    wb = w.detach().bfloat16().float()
    want = (x.detach().float() @ wb.t() + b.detach()).bfloat16()
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y, want, atol=0, rtol=0)
    y.backward(dy)
    dyf = dy.float().reshape(-1, 16)
    torch.testing.assert_close(x.grad, (dyf @ wb).bfloat16().reshape(4, 7, 32), atol=0, rtol=0)
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(
        w.grad, (dyf.t() @ x.detach().float().reshape(-1, 32)).bfloat16().float(),
        atol=0, rtol=0)
    torch.testing.assert_close(b.grad, dyf.sum(0), atol=1e-6, rtol=1e-6)


def _jax_bn(x, scale, bias, mean, var):
    return lambda xx, sc: JaxBNNeck(x.shape[1]).apply(
        {"params": {"scale": sc, "bias": bias}, "batch_stats": {"mean": mean, "var": var}},
        xx, train=True, mutable=["batch_stats"])


def test_bnneck_train_mode_and_running_stats_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 24)).astype(np.float32) * 2 + 0.5
    scale = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    mean = (0.1 * rng.standard_normal(24)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    dy = rng.standard_normal((8, 24)).astype(np.float32)
    fn = _jax_bn(x, scale, np.zeros(24, np.float32), mean, var)
    (jy, jmut), vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale))
    jdx, jdscale = vjp((jnp.asarray(dy), jax.tree_util.tree_map(jnp.zeros_like, jmut)))

    bn = BNNeck(24)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.running_mean.copy_(_t(mean))
        bn.running_var.copy_(_t(var))
    tx = _t(x).requires_grad_(True)
    y = bn(tx, train=True)
    y.backward(_t(dy))
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), _np(jdx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(bn.weight.grad), _np(jdscale), rtol=1e-5, atol=1e-5)
    stats = jmut["batch_stats"]
    np.testing.assert_allclose(_np(bn.running_mean), _np(stats["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(bn.running_var), _np(stats["var"]), atol=1e-6, rtol=0)
    assert int(bn.num_batches_tracked) == 1
    # eval mode reads the running statistics and leaves them alone
    before = bn.running_mean.clone()
    with torch.no_grad():
        ev = bn(_t(x))
    torch.testing.assert_close(bn.running_mean, before, atol=0, rtol=0)
    want = (_t(x) - bn.running_mean) * torch.rsqrt(bn.running_var + 1e-5) * bn.weight
    torch.testing.assert_close(ev, want.detach(), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# model: forward_train, and the whole train step from the same weights
# ---------------------------------------------------------------------------

def _perturbed(seed=0):
    jcfg = tiny_cfg(**{"INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                       "SOLVER.WEIGHT_DECAY": 1e-4, "SOLVER.WEIGHT_DECAY_BIAS": 1e-4,
                       "SOLVER.BIAS_LR_FACTOR": 2})
    jmodel, variables = tiny_model(jcfg, num_classes=NC)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.02 * rng.standard_normal(np.shape(x)).astype(np.float32), variables)
    clip = CLIPConfig(**dataclasses.asdict(jmodel.clip_config))
    tmodel = ReIDModel(clip, NC, camera_num=14, view_num=1)
    tmodel.load_state_dict(from_jax_variables(variables, clip), strict=True)
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, jmodel, variables, tcfg, tmodel, clip


def _batch(seed=3, n=8, hw=(32, 16)):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8),
            "pids": np.repeat(np.arange(n // 4), 4).astype(np.int32),
            "camids": rng.integers(0, 6, n).astype(np.int32),
            "trackids": np.zeros(n, np.int32)}


def _normalized(cfg, images):
    return jaug.eval_preprocess(jnp.asarray(images), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                                std=tuple(cfg.INPUT.PIXEL_STD))


def test_forward_train_matches_jax():
    jcfg, jmodel, variables, _, tmodel, clip = _perturbed()
    batch = _batch()
    x = _normalized(jcfg, batch["images"])
    out, mut = jmodel.apply(variables, x, jnp.asarray(batch["pids"]), train=True,
                            mutable=["batch_stats"])
    got = tmodel.forward_train(_t(x), _t(batch["pids"]).long())
    assert len(got["scores"]) == 2 and len(got["feats"]) == 3
    for g, w in zip(got["scores"] + got["feats"], out["scores"] + out["feats"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-5)
    ref = from_jax_variables({"params": variables["params"], "batch_stats": mut["batch_stats"]},
                             clip)
    sd = tmodel.state_dict()
    for name in ("bottleneck", "bottleneck_proj"):
        for stat in ("running_mean", "running_var"):
            np.testing.assert_allclose(_np(sd[f"{name}.{stat}"]), _np(ref[f"{name}.{stat}"]),
                                       atol=1e-6, rtol=0)
        assert int(sd[f"{name}.num_batches_tracked"]) == 1
    # feat_last is the class token after L-1 blocks, before ln_post
    feat_last, feat, *_ = tmodel.backbone_features(_t(x))
    assert not torch.allclose(feat_last, feat)


def _assert_grads_close(got, want):
    floor = 1e-3 * max(float(np.linalg.norm(_np(g))) for g in want.values())
    for name, g in got.items():
        diff = float(np.linalg.norm(_np(g) - _np(want[name])))
        bound = 1e-4 * max(float(np.linalg.norm(_np(want[name]))), floor)
        assert diff <= bound, (name, diff, bound)


@pytest.mark.parametrize("metric", ["triplet", "triplet_center"])
def test_train_step_matches_jax_make_train_step(metric):
    """One whole step from the same weights, augmentation off: the loss, every
    gradient, the BN running stats, the centers and the parameters after."""
    jcfg, jmodel, variables, tcfg, tmodel, clip = _perturbed()
    jcfg.MODEL.METRIC_LOSS_TYPE = tcfg.MODEL.METRIC_LOSS_TYPE = metric
    center = metric == "triplet_center"
    cw, clr = jcfg.SOLVER.CENTER_LOSS_WEIGHT, jcfg.SOLVER.CENTER_LR
    centers = np.random.default_rng(4).standard_normal((NC, 64)).astype(np.float32)
    batch = _batch()
    lr = 1e-3
    x = _normalized(jcfg, batch["images"])
    target = jnp.asarray(batch["pids"])
    jloss_fn, _ = jax_make_loss(jcfg, NC)

    def inner(params, cts):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x, target, train=True, mutable=["batch_stats"])
        loss = jloss_fn(out["scores"], out["feats"], target, None)
        if center:
            loss = loss + cw * jcenter.center_loss(cts, out["feats"][1], target)
        return loss, mut

    (jloss, jmut), (jg, jcg) = jax.value_and_grad(inner, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(centers))
    ref_g = from_jax_variables({"params": jg, "batch_stats": jmut["batch_stats"]}, clip)

    loss_fn, _ = make_loss(tcfg, NC)
    opt = toptim.make_optimizer(tcfg.SOLVER, tmodel, stage="baseline")
    loss, acc, grads, cgrad = loss_and_grads(
        tmodel, tcfg, loss_fn, opt, _t(x), _t(batch["pids"]).long(),
        centers=_t(centers) if center else None, center_weight=cw if center else None)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(grads) == {n for n, _ in tmodel.named_parameters()} - {
        "bottleneck.bias", "bottleneck_proj.bias"}
    _assert_grads_close(grads, ref_g)
    if center:
        assert _rel(cgrad, jcg) <= 1e-4
    sd = tmodel.state_dict()
    for name in ("bottleneck", "bottleneck_proj"):
        for stat in ("running_mean", "running_var"):
            np.testing.assert_allclose(_np(sd[f"{name}.{stat}"]), _np(ref_g[f"{name}.{stat}"]),
                                       atol=1e-6, rtol=0)

    # the step itself, through both packages' make_train_step
    tmodel.load_state_dict(from_jax_variables(variables, clip), strict=True)
    opt = toptim.make_optimizer(tcfg.SOLVER, tmodel, stage="baseline")
    state = initial_state(tmodel, opt, centers=_t(centers) if center else None)
    step = make_train_step(tmodel, tcfg, loss_fn, opt, center_weight=cw if center else None,
                           center_lr=clr if center else None)
    state, metrics = step(state, batch, lr, torch.Generator().manual_seed(0))
    assert metrics["loss"].dim() == 0 and metrics["acc"].dim() == 0
    jopt = joptim.make_optimizer(jcfg.SOLVER, variables["params"], stage="baseline")
    jstate = jax_initial_state(variables, jopt, centers=jnp.asarray(centers) if center else None)
    jstep = jax_make_train_step(jmodel, jcfg, jloss_fn, jopt, center_weight=cw if center else None,
                                center_lr=clr if center else None)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, lr,
                             jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jmetrics["loss"])) <= 1e-5 * abs(float(jloss))
    assert float(metrics["acc"]) == float(jmetrics["acc"])
    ref_p = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats}, clip)
    for name, p in tmodel.named_parameters():
        unit = lr * opt.lr_mult.get(name, 1.0)
        assert float(np.abs(_np(p) - _np(ref_p[name])).max()) <= 0.25 * unit, name
    assert state.opt_state.step == 1
    if center:
        np.testing.assert_allclose(_np(state.centers), _np(jstate.centers), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed=5, n=8, dim=16):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    logits = rng.standard_normal((n, NC)).astype(np.float32) * 3
    labels = np.repeat(np.arange(n // 4), 4).astype(np.int32)
    return feats, logits, labels


def _value_and_grad_both(jfn, tfn, array):
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(array))
    x = _t(array).requires_grad_(True)
    tval = tfn(x)
    tval.backward()
    return (float(tval.detach()), x.grad), (float(jval), jgrad)


@pytest.mark.parametrize("kind", ["ce", "ce_smooth", "triplet_margin", "triplet_soft", "center"])
def test_losses_match_jax(kind):
    feats, logits, labels = _loss_inputs()
    jl, tl = jnp.asarray(labels), _t(labels).long()
    centers = np.random.default_rng(6).standard_normal((NC, 16)).astype(np.float32)
    pairs = {
        "ce": (lambda a: jsoftmax.cross_entropy(a, jl),
               lambda a: tsoftmax.cross_entropy(a, tl), logits),
        "ce_smooth": (lambda a: jsoftmax.cross_entropy_label_smooth(a, jl, NC),
                      lambda a: tsoftmax.cross_entropy_label_smooth(a, tl, NC), logits),
        "triplet_margin": (lambda a: jtriplet.triplet_loss(a, jl, margin=0.3)[0],
                           lambda a: ttriplet.triplet_loss(a, tl, margin=0.3)[0], feats),
        "triplet_soft": (lambda a: jtriplet.triplet_loss(a, jl, margin=None)[0],
                         lambda a: ttriplet.triplet_loss(a, tl, margin=None)[0], feats),
        "center": (lambda a: jcenter.center_loss(jnp.asarray(centers), a, jl),
                   lambda a: tcenter.center_loss(_t(centers), a, tl), feats),
    }
    jfn, tfn, arr = pairs[kind]
    (tv, tg), (jv, jg) = _value_and_grad_both(jfn, tfn, arr)
    assert abs(tv - jv) <= 1e-5 * max(1.0, abs(jv))
    np.testing.assert_allclose(_np(tg), _np(jg), rtol=1e-5, atol=1e-6)


def test_distance_and_mining_match_jax():
    feats, _, labels = _loss_inputs(seed=7)
    jd = jtriplet.euclidean_dist(jnp.asarray(feats), jnp.asarray(feats))
    td = ttriplet.euclidean_dist(_t(feats), _t(feats))
    # the diagonal is the square root of rounding noise (about ‖x‖²·2⁻²³,
    # clamped at 1e-12), so it depends on the order of the sums
    off = ~np.eye(len(feats), dtype=bool)
    np.testing.assert_allclose(_np(td)[off], _np(jd)[off], rtol=1e-5, atol=1e-5)
    assert float(np.abs(np.diag(_np(td))).max()) <= 3e-3
    jap, jan = jtriplet.hard_example_mining(jd, jnp.asarray(labels))
    tap, tan = ttriplet.hard_example_mining(_t(np.asarray(jd)), _t(labels))
    np.testing.assert_array_equal(_np(tap), _np(jap))
    np.testing.assert_array_equal(_np(tan), _np(jan))


def test_mining_shares_a_tie_like_jax():
    """Two positives at the same largest distance split the gradient."""
    dist = np.array([[0.0, 2.0, 2.0, 1.0], [2.0, 0.0, 1.0, 3.0],
                     [2.0, 1.0, 0.0, 3.0], [1.0, 3.0, 3.0, 0.0]], np.float32)
    labels = np.array([0, 0, 0, 1], np.int32)
    jg = jax.grad(lambda d: jtriplet.hard_example_mining(d, jnp.asarray(labels))[0].sum())(
        jnp.asarray(dist))
    td = _t(dist).requires_grad_(True)
    ttriplet.hard_example_mining(td, _t(labels))[0].sum().backward()
    np.testing.assert_allclose(_np(td.grad), _np(jg), atol=0)


@pytest.mark.parametrize("smooth,no_margin", [("on", False), ("off", True)])
def test_make_loss_matches_jax(smooth, no_margin):
    jcfg = tiny_cfg(**{"MODEL.IF_LABELSMOOTH": smooth, "MODEL.NO_MARGIN": no_margin,
                       "MODEL.TRIPLET_LOSS_WEIGHT": 0.7})
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    rng = np.random.default_rng(8)
    scores = [rng.standard_normal((8, NC)).astype(np.float32) for _ in range(2)]
    feats = [rng.standard_normal((8, d)).astype(np.float32) for d in (64, 64, 32)]
    labels = np.repeat(np.arange(2), 4).astype(np.int32)
    jfn, _ = jax_make_loss(jcfg, NC)
    tfn, _ = make_loss(tcfg, NC)
    jv = jfn([jnp.asarray(s) for s in scores], [jnp.asarray(f) for f in feats],
             jnp.asarray(labels))
    tv = tfn([_t(s) for s in scores], [_t(f) for f in feats], _t(labels).long())
    assert abs(float(tv) - float(jv)) <= 1e-5 * abs(float(jv))


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["baseline", "stage2a", "stage2b"])
def test_groups_and_trainable_match_jax_for_every_leaf(stage):
    """The JAX package's lr multiplier, weight decay and trainable flag of
    every parameter, carried to torch names through the converter's name
    map (each leaf filled with its value), against the port's decisions."""
    jcfg = tiny_cfg(**{"SOLVER.BIAS_LR_FACTOR": 2, "SOLVER.LARGE_FC_LR": True,
                       "SOLVER.WEIGHT_DECAY": 1e-4, "SOLVER.WEIGHT_DECAY_BIAS": 5e-4})
    jmodel, variables = tiny_model(jcfg, num_classes=NC)
    clip = CLIPConfig(**dataclasses.asdict(jmodel.clip_config))
    tmodel = ReIDModel(clip, NC, camera_num=14, view_num=1)
    params = variables["params"]
    jmult, jwd = joptim.group_trees(params, jcfg.SOLVER)
    jtrain = joptim.stage_trainable(params, stage)
    tmult, twd = toptim.group_trees(tmodel, jcfg.SOLVER)
    ttrain = toptim.stage_trainable(tmodel, stage)
    names = {n for n, _ in tmodel.named_parameters()}
    assert set(tmult) == set(twd) == set(ttrain) == names
    for jtree, tdict in ((jmult, tmult), (jwd, twd), (jtrain, ttrain)):
        filled = jax.tree_util.tree_map(lambda p, v: np.full(np.shape(p), float(v), np.float32),
                                        params, jtree)
        carried = from_jax_variables({"params": filled, "batch_stats": variables["batch_stats"]},
                                     clip)
        for name in names:
            assert np.unique(_np(carried[name])).tolist() == [float(np.float32(tdict[name]))], name


_LEAVES = {"enc.fc.weight": (24, 16), "enc.fc.bias": (24,), "enc.ln.bias": (16,),
           "classifier.weight": (NC, 16), "bottleneck.weight": (16,), "bottleneck.bias": (16,)}


def _nest(flat):
    out = {}
    for name, value in flat.items():
        node = out
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW"])
def test_optimizer_update_matches_jax(name, moment_dtype):
    """Two updates of every optimizer and moment type against the JAX
    package's Optimizer.update, leaf by leaf (frozen BNNeck bias included)."""
    jcfg = tiny_cfg(**{"SOLVER.BIAS_LR_FACTOR": 2, "SOLVER.LARGE_FC_LR": True,
                       "SOLVER.WEIGHT_DECAY": 1e-2, "SOLVER.WEIGHT_DECAY_BIAS": 5e-3,
                       "SOLVER.MOMENT_DTYPE": moment_dtype, "SOLVER.OPTIMIZER_NAME": name})
    rng = np.random.default_rng(9)
    flat = {k: rng.standard_normal(s).astype(np.float32) for k, s in _LEAVES.items()}
    jopt = joptim.make_optimizer(jcfg.SOLVER, _nest(flat), stage="baseline")
    tparams = {k: _t(v) for k, v in flat.items()}
    topt = toptim.make_optimizer(jcfg.SOLVER, tparams, stage="baseline")
    assert topt.moment_dtype == (torch.bfloat16 if moment_dtype == "bfloat16" else torch.float32)
    jstate = jopt.init(_nest(flat))
    tstate = topt.init(tparams)
    jtrain, _ = jopt.partition(_nest(flat))
    ttrain, tfrozen = topt.partition(tparams)
    assert set(tfrozen) == {"bottleneck.bias"}
    for it, lr in enumerate((1e-2, 3e-3)):
        grads = {k: (rng.standard_normal(_LEAVES[k]) * 10.0 ** -it).astype(np.float32)
                 for k in ttrain}
        jtrain, jstate = jopt.update({tuple(k.split(".")): jnp.asarray(g) for k, g in grads.items()},
                                     jstate, jtrain, lr)
        tstate = topt.update({k: _t(g) for k, g in grads.items()}, tstate, ttrain, lr)
    assert tstate.step == 2
    for k in ttrain:
        key = tuple(k.split("."))
        np.testing.assert_allclose(_np(ttrain[k]), _np(jtrain[key]), rtol=1e-5, atol=1e-6)
        assert tstate.mu[k].dtype == topt.moment_dtype
        np.testing.assert_allclose(_np(tstate.mu[k]), _np(jstate.mu[key]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(_np(tstate.nu[k]), _np(jstate.nu[key]), rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(_np(tfrozen["bottleneck.bias"]), flat["bottleneck.bias"])


@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_plain_adam_leaf_matches_pallas_interpret(decoupled, moment_dtype):
    """The plain leaf update (the CPU path of fused_adam_leaf) against the
    JAX package's Pallas kernel in interpret mode, on an unaligned leaf."""
    rng = np.random.default_rng(10)
    shape = (257, 130)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    m = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    v = np.abs(rng.standard_normal(shape) * 1e-4).astype(np.float32)
    b1, b2, eps, wd, lr, t = 0.9, 0.999, 1e-8, 1e-4, 6e-4, 5
    jmd, tmd = getattr(jnp, moment_dtype), getattr(torch, moment_dtype)
    scalars = jnp.asarray([lr, 1 - b1 ** t, 1 - b2 ** t], jnp.float32)
    jp, jm, jv = jax_fused_adam_leaf(jnp.asarray(p), jnp.asarray(m).astype(jmd),
                                     jnp.asarray(v).astype(jmd), jnp.asarray(g), scalars,
                                     b1, b2, eps, wd, decoupled, jmd, interpret=True)
    tp, tm, tv = _t(p), _t(m).to(tmd), _t(v).to(tmd)
    before = tadam.fused_adam_leaf.launches
    tadam.fused_adam_leaf(tp, tm, tv, _t(g), _t(np.asarray(scalars)), b1, b2, eps, wd,
                          decoupled)
    assert tadam.fused_adam_leaf.launches == before  # CPU: the plain version
    np.testing.assert_allclose(_np(tp), _np(jp), rtol=1e-6, atol=1e-7)
    # bf16 moments to one bf16 step: an fp32 moment that differs in its last
    # bit (XLA may contract a multiply-add) can round to either neighbour
    rtol = 2.0 ** -8 if moment_dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=rtol, atol=1e-8)
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=rtol, atol=1e-10)


def test_fused_adam_is_used_only_on_the_card():
    """FUSED_ADAM on CPU parameters takes the plain path (no launch) and
    gives the unfused optimizer's result exactly."""
    cfg = get_default_cfg()
    cfg.SOLVER.FUSED_ADAM = True
    rng = np.random.default_rng(11)
    big = {"big.weight": rng.standard_normal((tadam.MIN_FUSED_SIZE,)).astype(np.float32)}
    results = []
    for fused in (True, False):
        cfg.SOLVER.FUSED_ADAM = fused
        params = {k: _t(v) for k, v in big.items()}
        opt = toptim.make_optimizer(cfg.SOLVER, params)
        state = opt.init(params)
        before = tadam.fused_adam_leaf.launches
        opt.update({k: _t(v * 0.5) for k, v in big.items()}, state, params, 1e-3)
        assert tadam.fused_adam_leaf.launches == before
        results.append(params["big.weight"])
    torch.testing.assert_close(results[0], results[1], atol=0, rtol=0)


class _OnTheCard:
    """A leaf as ``Optimizer.route`` sees it: its size, on the card."""

    is_cuda = True

    def __init__(self, p):
        self.n = p.numel()

    def numel(self):
        return self.n


@pytest.mark.parametrize("fused", [False, True])
def test_adam_route_of_every_stage2a_leaf(fused):
    """Where each of stage 2a's 161 trainable leaves (the Uni-Prompt
    ViT-B/16 of configs/ours/cctv_ir_cctv_rgb.yml, built on the meta
    device) is updated: on the card, every leaf in the one table with
    FUSED_ADAM off; with it on, the 53 of at least MIN_FUSED_SIZE elements
    on the per-leaf kernel and the other 108 in the table. Leaves off the
    card take the plain path, and so does every leaf under SGD."""
    from mpreid_tpu_torch.models.factory import build_model_uniprompt

    cfg = get_default_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" / "ours"
                            / "cctv_ir_cctv_rgb.yml"))
    cfg.SOLVER.STAGE2.FUSED_ADAM = fused
    with torch.device("meta"):
        model = build_model_uniprompt(cfg, 751, 6, 1)
    opt = toptim.make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2a")
    assert opt.name == "Adam"
    train, _ = opt.partition(model)
    routes = {k: opt.route(_OnTheCard(p)) for k, p in train.items()}
    big = {k for k, p in train.items() if p.numel() >= tadam.MIN_FUSED_SIZE}
    assert len(train) == 161 and len(big) == 53
    want = {k: "leaf" if fused and k in big else "table" for k in train}
    assert routes == want
    assert {opt.route(p) for p in train.values()} == {"plain"}  # meta tensors: off the card
    opt.name = "SGD"
    assert {opt.route(_OnTheCard(p)) for p in train.values()} == {"plain"}


def test_center_optimizer_matches_jax():
    rng = np.random.default_rng(12)
    c, g = rng.standard_normal((4, 6)).astype(np.float32), rng.standard_normal((4, 6)).astype(np.float32)
    want = joptim.CenterOptimizer(0.5, 5e-4).update(jnp.asarray(g), jnp.asarray(c))
    got = toptim.CenterOptimizer(0.5, 5e-4).update(_t(g), _t(c))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_schedules_match_jax():
    cfg = tiny_cfg(**{"SOLVER.STEPS": (3, 6), "SOLVER.WARMUP_ITERS": 4, "SOLVER.MAX_EPOCHS": 9,
                      "SOLVER.WARMUP_EPOCHS": 2})
    for kind in ("multistep", "cosine"):
        js, ts = jsched.make_scheduler(cfg.SOLVER, kind), tsched.make_scheduler(cfg.SOLVER, kind)
        assert [ts(e) for e in range(12)] == [js(e) for e in range(12)]
    for method in ("linear", "constant"):
        args = (5e-6, [30, 50], 0.1, 0.1, 10, method)
        js, ts = jsched.warmup_multistep(*args), tsched.warmup_multistep(*args)
        assert [ts(e) for e in range(61)] == [js(e) for e in range(61)]
    cos = dict(base_lr=1e-3, t_initial=5, lr_min=1e-5, warmup_t=2, warmup_lr_init=1e-4,
               cycle_limit=2)
    js, ts = jsched.warmup_cosine(**cos), tsched.warmup_cosine(**cos)
    assert [ts(e) for e in range(14)] == [js(e) for e in range(14)]
    for rng_t in ((2, 6), 3, None):
        jn = jsched.with_lr_noise(jsched.warmup_cosine(**cos), rng_t)
        tn = tsched.with_lr_noise(tsched.warmup_cosine(**cos), rng_t)
        assert [tn(e) for e in range(10)] == [jn(e) for e in range(10)]
    with pytest.raises(ValueError, match="increasing"):
        tsched.warmup_multistep(1.0, [5, 2])


# ---------------------------------------------------------------------------
# augmentation, fed the JAX package's own draws
# ---------------------------------------------------------------------------

def _jax_draws(key, b, h, w, flip_prob, padding, re_prob):
    """Every draw of jax train_augment, by repeating its key splits
    (ops/augment.py:113-127 and _random_erase)."""
    out = {k: [] for k in ("flip", "offsets", "gate", "area", "log_ratio", "y", "x", "noise")}
    for k in jax.random.split(key, b):
        k_flip, k_crop = jax.random.split(k)
        out["flip"].append(bool(jax.random.uniform(k_flip) < flip_prob))
        ky, kx = jax.random.split(k_crop)
        out["offsets"].append([int(jax.random.randint(ky, (), 0, 2 * padding + 1)),
                               int(jax.random.randint(kx, (), 0, 2 * padding + 1))])
        k_gate, k_area, k_aspect, k_y, k_x, k_noise = jax.random.split(
            jax.random.fold_in(k, 0x5EED), 6)
        out["gate"].append(bool(jax.random.uniform(k_gate) < re_prob))
        out["area"].append(float(jax.random.uniform(
            k_area, minval=jaug.MIN_ERASE_AREA, maxval=jaug.MAX_ERASE_AREA)))
        out["log_ratio"].append(float(jax.random.uniform(
            k_aspect, minval=jnp.log(jaug.MIN_ERASE_ASPECT),
            maxval=jnp.log(1.0 / jaug.MIN_ERASE_ASPECT))))
        out["y"].append(int(jax.random.randint(k_y, (), 0, h)))
        out["x"].append(int(jax.random.randint(k_x, (), 0, w)))
        out["noise"].append(np.asarray(jax.random.normal(k_noise, (h, w, 3), jnp.float32)))
    return out


@pytest.mark.parametrize("padding", [10, 0])
def test_train_augment_with_jax_draws_matches_jax(padding):
    b, h, w = 6, 32, 16
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    images = np.random.default_rng(13).integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(7)
    want = jaug.train_augment(jnp.asarray(images), key, mean=mean, std=std, flip_prob=0.5,
                              padding=padding, re_prob=0.5)
    d = _jax_draws(key, b, h, w, 0.5, padding, 0.5)
    rect = taug.erase_rectangles(_t(np.float32(d["area"])), _t(np.float32(d["log_ratio"])),
                                 _t(d["y"]), _t(d["x"]), h, w)
    got = taug.train_augment_with_draws(
        _t(images), flip=_t(d["flip"]), offsets=_t(d["offsets"]), gate=_t(d["gate"]), rect=rect,
        noise=_t(np.stack(d["noise"])), mean=mean, std=std, padding=padding)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, w, 3)
    assert any(d["flip"]) and not all(d["flip"]) and any(d["gate"]) and not all(d["gate"])
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_train_augment_draws_on_a_generator():
    images = torch.from_numpy(np.random.default_rng(14).integers(0, 256, (16, 32, 16, 3),
                                                                  dtype=np.uint8))
    a = taug.train_augment(images, torch.Generator().manual_seed(3), padding=4)
    b = taug.train_augment(images, torch.Generator().manual_seed(3), padding=4)
    c = taug.train_augment(images, torch.Generator().manual_seed(4), padding=4)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    off = taug.train_augment(images, torch.Generator().manual_seed(3), flip_prob=0.0,
                             padding=0, re_prob=0.0)
    torch.testing.assert_close(off, taug.eval_preprocess(images), atol=0, rtol=0)
    d = taug.train_augment_draws(64, 32, 16, torch.Generator().manual_seed(5))
    y0, x0, eh, ew = d["rect"].unbind(1)
    assert bool(((eh >= 1) & (eh <= 31) & (ew >= 1) & (ew <= 15)).all())
    assert bool(((y0 >= 0) & (y0 + eh <= 32) & (x0 >= 0) & (x0 + ew <= 16)).all())
    assert 0 <= int(d["offsets"].min()) and int(d["offsets"].max()) <= 20


# ---------------------------------------------------------------------------
# loops: do_train, checkpoints, resume, the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("m1501_train")
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    return str(root)


def _train_cfg(root, out_dir, **overrides):
    cfg = get_default_cfg()
    cfg.merge_from_other_cfg(tiny_cfg())
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.DEBUG_TINY = True
    cfg.DATASETS.NAMES = "market1501"
    cfg.DATASETS.ROOT_DIR = root
    cfg.OUTPUT_DIR = str(out_dir)
    cfg.SOLVER.BASE_LR = 3e-3
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    cfg.SOLVER.EVAL_PERIOD = 100
    for k, v in overrides.items():
        node = cfg
        *parents, leaf = k.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = v
    return cfg


def _training_setup(cfg):
    from mpreid_tpu_torch.data import make_dataloader
    from mpreid_tpu_torch.models import make_model

    tl, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
    model = make_model(cfg, ncls, ncam, nview)
    loss_fn, _ = make_loss(cfg, ncls)
    opt = toptim.make_optimizer(cfg.SOLVER, model, stage="baseline")
    return model, tl, val, nq, loss_fn, opt


def _batches(loader, epoch):
    return len(loader.sampler.epoch_indices(epoch)) // loader.batcher.batch_size


def test_do_train_loss_decreases_and_validates(market, tmp_path):
    cfg = _train_cfg(market, tmp_path, **{"SOLVER.EVAL_PERIOD": 4})
    model, tl, val, nq, loss_fn, opt = _training_setup(cfg)
    state, history = do_train(cfg, model, tl, val, opt, lambda e: cfg.SOLVER.BASE_LR,
                              loss_fn, nq, max_epochs=4)
    assert [h["epoch"] for h in history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert history[-1]["loss"] < history[0]["loss"]
    assert state.opt_state.step == sum(_batches(tl, e) for e in range(1, 5))
    assert os.path.exists(tmp_path / "ViT-B-16_4.pth")


def test_checkpoint_round_trip_and_resume(market, tmp_path):
    cfg = _train_cfg(market, tmp_path, **{"SOLVER.MOMENT_DTYPE": "bfloat16"})
    model, tl, val, nq, loss_fn, opt = _training_setup(cfg)
    state, _ = do_train(cfg, model, tl, None, opt, lambda e: 1e-3, loss_fn, nq, max_epochs=1)
    path = str(tmp_path / "ViT-B-16_1.pth")
    payload = load_checkpoint(path)
    assert payload["epoch"] == 1 and payload["opt_state"]["step"] == _batches(tl, 1)

    # a fresh model and optimizer take back every tensor of the state
    fresh, *_, fresh_opt = _training_setup(cfg)
    fresh_state = initial_state(fresh, fresh_opt)
    assert restore_state(fresh_state, payload) == 1
    for (name, a), (_, b) in zip(model.state_dict().items(), fresh.state_dict().items()):
        torch.testing.assert_close(b, a, atol=0, rtol=0, msg=name)
    assert fresh_state.opt_state.step == state.opt_state.step
    for key in ("mu", "nu"):
        for name, t in getattr(state.opt_state, key).items():
            got = getattr(fresh_state.opt_state, key)[name]
            assert got.dtype == torch.bfloat16
            torch.testing.assert_close(got, t, atol=0, rtol=0)

    # test.py's load_param reads the weights out of the checkpoint
    weights_only, *_ = _training_setup(cfg)
    load_param(path, weights_only)
    torch.testing.assert_close(weights_only.state_dict()["classifier.weight"],
                               model.state_dict()["classifier.weight"], atol=0, rtol=0)

    # SOLVER.RESUME continues at the next epoch from the saved state
    cfg.SOLVER.RESUME = path
    resumed, *_, resumed_opt = _training_setup(cfg)
    state2, history = do_train(cfg, resumed, tl, None, resumed_opt, lambda e: 1e-3, loss_fn,
                               nq, max_epochs=2)
    assert [h["epoch"] for h in history] == [2]
    assert state2.opt_state.step == _batches(tl, 1) + _batches(tl, 2)


def test_do_train_refuses_what_is_not_ported(market, tmp_path):
    """TPU.DEVICE_DATASET raised until the device epoch was ported: one
    epoch over the resident train set now gives the step loop's history,
    weights and checkpoint (epoch 1 has epoch 0's batch count, so both see
    the same batches)."""
    runs = []
    for on in (False, True):
        cfg = _train_cfg(market, tmp_path / str(on), **{"TPU.DEVICE_DATASET": on})
        model, tl, val, nq, loss_fn, opt = _training_setup(cfg)
        state, history = do_train(cfg, model, tl, None, opt, lambda e: 1e-3, loss_fn, nq,
                                  max_epochs=1)
        runs.append((history, state.opt_state.step, load_checkpoint(
            str(tmp_path / str(on) / "ViT-B-16_1.pth"))["model"]))
    (h0, n0, s0), (h1, n1, s1) = runs
    assert h0 == h1 and n0 == n1 == _batches(tl, 1)
    for name, t in s0.items():
        torch.testing.assert_close(s1[name], t, atol=0, rtol=0, msg=name)


def test_train_cli_one_epoch_on_the_cpu(market, tmp_path):
    cmd = [sys.executable, "-m", "mpreid_tpu_torch.train",
           "--config_file", os.path.join(REPO, "configs", "person", "vit_base.yml"),
           "MODEL.DEVICE", "cpu", "MODEL.DEBUG_TINY", "True",
           "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
           "SOLVER.IMS_PER_BATCH", "8", "TEST.IMS_PER_BATCH", "16",
           "SOLVER.MAX_EPOCHS", "1", "SOLVER.CHECKPOINT_PERIOD", "1", "SOLVER.EVAL_PERIOD", "1",
           "DATALOADER.NUM_WORKERS", "2", "DATASETS.ROOT_DIR", market,
           "OUTPUT_DIR", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, cwd=str(tmp_path), capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Epoch 1 done" in out.stdout and "Validation Results - Epoch: 1" in out.stdout
    assert os.path.exists(tmp_path / "ViT-B-16_1.pth")
    payload = load_checkpoint(str(tmp_path / "ViT-B-16_1.pth"))
    assert payload["opt_state"]["mu"]["classifier.weight"].dtype == torch.float32


def test_train_cli_refuses_pretrained_weights():
    """CLIP weights come from a local file only: ``MODEL.PRETRAIN_AUTO``
    without ``MODEL.PRETRAIN_PATH`` (a download) raises and names the path
    key, before any data is read."""
    from mpreid_tpu_torch import train as entry

    with pytest.raises(NotImplementedError, match="MODEL.PRETRAIN_PATH"):
        entry.main(["MODEL.DEVICE", "cpu", "MODEL.PRETRAIN_AUTO", "True"])
