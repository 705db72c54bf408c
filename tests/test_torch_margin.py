"""The port's margin heads (``MODEL.COS_LAYER``) against the JAX package's.

``losses/margin.py`` function by function (values and the gradients with
respect to the features and the weight, circle's detached factors
included), ``MarginHead`` with and without labels, the train-time scores of
``ReIDModel`` and ``UniPromptReID`` with a margin head, ``from_jax_variables``
on a margin-head tree (the JAX package's ``export_reid_state_dict`` reads
a Dense ``kernel`` and cannot export one), one baseline step and one
Uni-Prompt stage-2a step per kind through both packages'
``make_train_step``, and the training entry points with the flag on.

Weights are seeded numpy values in the structure of the JAX package's
abstract init (``test_torch_moe.py::_seeded``); the CLIP is the tiny one of
``tests/tiny.py`` in fp32 on the CPU. Tolerances, fp32: margin logits and
losses to 1e-5 relative to max(1, max |value|), their gradients to 1e-5
norm-relative; a model's scores to 1e-4 (after a tower, as
``tests/test_torch_train.py``); a step's loss to 1e-5 relative, every
gradient to 1e-4 norm-relative floored at 1e-3 of the largest leaf's, and
the parameters after it to 0.25·lr·mult, 2·lr·mult where Adam's first
step is set by rounding (``_assert_params_close``).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.data.synthetic import make_market1501
from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine import uniprompt as juni
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.losses import margin as jmargin
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.layers import MarginHead as JaxMarginHead
from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUniPromptReID
from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    initial_state, loss_and_grads, make_train_step, precompute_text_features,
)
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.losses import margin as tmargin
from mpreid_tpu_torch.models import (
    CLIPConfig, ReIDModel, UniPromptReID, from_jax_variables, make_model,
)
from mpreid_tpu_torch.models.layers import Linear, MarginHead, make_classifier
from mpreid_tpu_torch.solver import make_optimizer

from test_torch_moe import _seeded
from tiny import tiny_cfg, tiny_clip_config

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("arcface", "cosface", "amsoftmax", "circle")
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
# losses/margin.py
# ---------------------------------------------------------------------------

def _margin_inputs(c=9, b=6, d=16, seed=0):
    """Features, a (C, feat) weight, labels and a cotangent; row 0 points
    almost opposite its class's weight row (cos θ ≈ -0.95), so ArcFace's
    ``cos θ > cos(π − m)`` test takes its other branch there."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c, d)).astype(np.float32)
    feats = rng.standard_normal((b, d)).astype(np.float32)
    labels = np.arange(b, dtype=np.int64) % c
    feats[0] = -w[labels[0]] + 0.3 * np.linalg.norm(w[labels[0]]) / np.sqrt(d) * \
        rng.standard_normal(d).astype(np.float32)
    cot = rng.standard_normal((b, c)).astype(np.float32)
    return feats, w, labels, cot


MARGIN_CASES = {
    "arcface": ("arcface_logits", {}, False),
    "arcface-easy_margin": ("arcface_logits", {"easy_margin": True}, False),
    "arcface-ls_eps": ("arcface_logits", {"ls_eps": 0.1}, False),
    "cosface": ("cosface_logits", {}, False),
    "amsoftmax": ("amsoftmax_logits", {}, True),
    "circle": ("circle_logits", {}, False),
}


@pytest.mark.parametrize("case", list(MARGIN_CASES))
def test_margin_logits_and_gradients_match_jax(case):
    name, kwargs, transposed = MARGIN_CASES[case]
    feats, w, labels, cot = _margin_inputs()
    if transposed:
        w = np.ascontiguousarray(w.T)  # AMSoftmax's weight is (feat, C)
    jfn = getattr(jmargin, name)
    jl = jnp.asarray(labels.astype(np.int32))

    def jloss(f, wt):
        return jnp.sum(jfn(f, wt, jl, **kwargs) * jnp.asarray(cot))

    want = jfn(jnp.asarray(feats), jnp.asarray(w), jl, **kwargs)
    jgf, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    tf, tw = _t(feats).requires_grad_(True), _t(w).requires_grad_(True)
    got = getattr(tmargin, name)(tf, tw, _t(labels), **kwargs)
    (got * _t(cot)).sum().backward()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(_np(want)).max()))
    assert float(np.abs(_np(got) - _np(want)).max()) <= 1e-5 * scale
    assert _rel(tf.grad, jgf) <= 1e-5 and _rel(tw.grad, jgw) <= 1e-5
    if name == "arcface_logits" and not kwargs:
        cosine = _np(tmargin._cosine_logits(_t(feats), _t(w)))
        assert cosine[0, labels[0]] < np.cos(np.pi - 0.5)  # the other branch ran


def test_circle_factors_carry_no_gradient():
    """Circle's alpha_p / alpha_n are detached: the gradient equals the one
    taken with the factors held as constants."""
    feats, w, labels, cot = _margin_inputs(seed=1)
    tf = _t(feats).requires_grad_(True)
    (tmargin.circle_logits(tf, _t(w), _t(labels)) * _t(cot)).sum().backward()
    sim0 = _np(tmargin._cosine_logits(_t(feats), _t(w)))
    ap, an = np.maximum(1.25 - sim0, 0.0), np.maximum(sim0 + 0.25, 0.0)
    one_hot = np.eye(w.shape[0], dtype=np.float32)[labels]
    coeff = _t(256.0 * (one_hot * ap + (1 - one_hot) * an) * cot)
    tf2 = _t(feats).requires_grad_(True)
    (tmargin._cosine_logits(tf2, _t(w)) * coeff).sum().backward()
    torch.testing.assert_close(tf.grad, tf2.grad, rtol=1e-5, atol=1e-5)


def test_contrastive_loss_matches_jax():
    """Features of norm 0.8 (each self-similarity 0.64 < 1, so every anchor
    counts its own pair in both frameworks), ids with 2-3 images."""
    rng = np.random.default_rng(2)
    f = rng.standard_normal((10, 12)).astype(np.float32)
    f = 0.8 * f / np.linalg.norm(f, axis=1, keepdims=True)
    labels = np.array([0, 0, 1, 1, 1, 2, 2, 3, 3, 3])
    want, jg = jax.value_and_grad(lambda x: jmargin.contrastive_loss(
        x, jnp.asarray(labels.astype(np.int32))))(jnp.asarray(f))
    tf = _t(f).requires_grad_(True)
    got = tmargin.contrastive_loss(tf, _t(labels))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    assert _rel(tf.grad, jg) <= 1e-5


@pytest.mark.parametrize("kind", KINDS)
def test_margin_head_matches_jax(kind):
    """With labels (margin logits) and without (s · cos θ), s 30 or 256 for
    circle; the gradient of the weight too."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((6, 16)).astype(np.float32)
    w = 0.05 * rng.standard_normal((NC, 16)).astype(np.float32)
    labels = rng.integers(0, NC, 6)
    jhead = JaxMarginHead(NC, kind=kind)
    head = MarginHead(16, NC, kind=kind)
    assert head.effective_scale == jhead.effective_scale == (256.0 if kind == "circle" else 30.0)
    with torch.no_grad():
        head.weight.copy_(_t(w))
    for lab in (labels, None):
        jlab = None if lab is None else jnp.asarray(lab.astype(np.int32))

        def jf(wt):
            return jhead.apply({"params": {"weight": wt}}, jnp.asarray(feats), jlab)

        want, vjp = jax.vjp(jf, jnp.asarray(w))
        head.weight.grad = None
        got = head(_t(feats), None if lab is None else _t(lab))
        cot = rng.standard_normal(want.shape).astype(np.float32)
        (got * _t(cot)).sum().backward()
        scale = max(1.0, float(np.abs(_np(want)).max()))
        assert float(np.abs(_np(got) - _np(want)).max()) <= 1e-5 * scale, lab
        assert _rel(head.weight.grad, vjp(jnp.asarray(cot))[0]) <= 1e-5, lab


def test_make_classifier_and_the_unknown_kind():
    """make_classifier returns a margin head for a kind and the plain
    bias-free classifier without; an unknown kind raises JAX's ValueError;
    the margin head's init draws as the plain classifier's does."""
    assert isinstance(make_classifier(NC, 16, ""), Linear)
    head = make_classifier(NC, 16, "cosface")
    assert isinstance(head, MarginHead) and tuple(head.weight.shape) == (NC, 16)
    plain = make_classifier(NC, 16)
    head.init_(torch.Generator().manual_seed(5), std=0.001)
    plain.init_(torch.Generator().manual_seed(5), std=0.001)
    torch.testing.assert_close(head.weight, plain.weight, atol=0, rtol=0)
    with pytest.raises(ValueError, match="Unknown MODEL.COS_LAYER_TYPE 'sphere'"):
        make_classifier(NC, 16, "sphere")
    with pytest.raises(ValueError, match="Unknown MODEL.COS_LAYER_TYPE 'sphere'"):
        JaxMarginHead(NC, kind="sphere").init(jax.random.PRNGKey(0), jnp.zeros((2, 16)),
                                               jnp.zeros(2, jnp.int32))


# ---------------------------------------------------------------------------
# the models and the train steps
# ---------------------------------------------------------------------------

def _cfg(**overrides):
    jcfg = tiny_cfg(**{"INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                       "SOLVER.WEIGHT_DECAY": 1e-4, "SOLVER.WEIGHT_DECAY_BIAS": 1e-4,
                       "SOLVER.BIAS_LR_FACTOR": 2, "SOLVER.STAGE2.WEIGHT_DECAY": 1e-4,
                       "SOLVER.STAGE2.WEIGHT_DECAY_BIAS": 1e-4,
                       "SOLVER.STAGE2.BIAS_LR_FACTOR": 2, **overrides})
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_model(uniprompt: bool, kind: str):
    """(clip config, JAX model with margin heads, seeded variables), once
    per configuration."""
    clip = tiny_clip_config()
    cls = JaxUniPromptReID if uniprompt else JaxReIDModel
    jmodel = cls(clip_config=clip, num_classes=NC, camera_num=14, view_num=1, cos_layer=kind)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), _cfg()[0], abstract=True))
    return clip, jmodel, variables


def _pair(uniprompt: bool, kind: str):
    clip, jmodel, variables = _jax_model(uniprompt, kind)
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    cls = UniPromptReID if uniprompt else ReIDModel
    tmodel = cls(tclip, NC, camera_num=14, view_num=1, cos_layer=kind)
    tmodel.load_state_dict(from_jax_variables(variables, tclip), strict=True)
    return jmodel, variables, tmodel, tclip


def _batch(seed=3, n=8):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (n, 32, 16, 3), dtype=np.uint8),
            "pids": np.repeat(np.arange(n // 4), 4).astype(np.int32),
            "camids": rng.integers(0, 6, n).astype(np.int32),
            "trackids": np.zeros(n, np.int32)}


def _normalized(cfg, images):
    from mpreid_tpu.ops import augment as jaug

    return jaug.eval_preprocess(jnp.asarray(images), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                                std=tuple(cfg.INPUT.PIXEL_STD))


def test_from_jax_variables_copies_a_margin_head_without_the_transpose():
    """A margin head's JAX leaf is ``weight`` (C, feat), already the port's
    layout; a Dense head's ``kernel`` (feat, C) is transposed."""
    _, variables = _jax_model(False, "arcface")[1:]
    clip = CLIPConfig(**dataclasses.asdict(_jax_model(False, "arcface")[0]))
    sd = from_jax_variables(variables, clip)
    for name in ("classifier", "classifier_proj"):
        leaf = np.asarray(variables["params"][name]["weight"])
        np.testing.assert_array_equal(sd[f"{name}.weight"].numpy(), leaf)
    dense = {"params": {**variables["params"],
                        "classifier": {"kernel": leaf.T.copy()},
                        "classifier_proj": {"kernel": np.asarray(
                            variables["params"]["classifier_proj"]["weight"]).T.copy()}},
             "batch_stats": variables["batch_stats"]}
    sd2 = from_jax_variables(dense, clip)
    np.testing.assert_array_equal(sd2["classifier_proj.weight"].numpy(), leaf)


@pytest.mark.parametrize("uniprompt", [False, True], ids=["reid", "uniprompt"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_train_scores_with_cos_layer_match_jax(kind, uniprompt):
    jmodel, variables, tmodel, _ = _pair(uniprompt, kind)
    jcfg = _cfg()[0]
    batch = _batch()
    x = _normalized(jcfg, batch["images"])
    out = jmodel.apply(variables, x, jnp.asarray(batch["pids"]), train=True,
                       mutable=["batch_stats"])[0]
    got = tmodel.forward_train(_t(np.asarray(x)), _t(batch["pids"]).long())
    for g, w in zip(got["scores"], out["scores"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape == (8, NC)
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=1e-4)


def _assert_grads_close(got, want):
    floor = 1e-3 * max(float(np.linalg.norm(_np(want[n]))) for n in got)
    for name, g in got.items():
        diff = float(np.linalg.norm(_np(g) - _np(want[name])))
        assert diff <= 1e-4 * max(float(np.linalg.norm(_np(want[name]))), floor), name


def _assert_params_close(tmodel, ref, lr, opt, weights, grads, ref_grads):
    """Parameters after one Adam step to 0.25·lr·mult, except where the
    coupled gradient g' = g + wd·p is below 100·eps or has another sign in
    the two frameworks: Adam's first step, lr·g'/(|g'| + eps), is then set
    by rounding, and those elements are held to 2·lr·mult (the rule of
    ``chip_smoke.py::uniprompt_cross_checks``)."""
    for name, param in tmodel.named_parameters():
        err = np.abs(_np(param) - _np(ref[name]))
        if name not in grads:  # frozen: unchanged in both
            assert not err.any() and not np.any(_np(param) - _np(weights[name])), name
            continue
        unit = lr * opt.lr_mult[name]
        p0 = _np(weights[name])
        g_t, g_j = (_np(g[name]) + opt.wd[name] * p0 for g in (grads, ref_grads))
        loose = (np.abs(g_j) < 100 * opt.eps) | (np.sign(g_t) != np.sign(g_j))
        assert float(err[~loose].max(initial=0.0)) <= 0.25 * unit, (name, float(err.max()), unit)
        assert float(err.max()) <= 2 * unit, (name, float(err.max()), unit)


@pytest.mark.parametrize("uniprompt", [False, True], ids=["baseline", "stage2a"])
@pytest.mark.parametrize("kind", KINDS)
def test_train_step_with_cos_layer_matches_jax(kind, uniprompt):
    """One step from the same weights, augmentation off, through both
    packages' make_train_step (baseline, or Uni-Prompt stage 2a with the i2t
    term): the loss and every gradient (``loss_and_grads`` against
    ``jax.value_and_grad``), the accuracy and every parameter after it."""
    jmodel, variables, tmodel, tclip = _pair(uniprompt, kind)
    jcfg, tcfg = _cfg()
    solver, stage = ((jcfg.SOLVER.STAGE2, "stage2a") if uniprompt
                     else (jcfg.SOLVER, "baseline"))
    tsolver = tcfg.SOLVER.STAGE2 if uniprompt else tcfg.SOLVER
    batch = _batch()
    lr = 1e-3
    x = _normalized(jcfg, batch["images"])
    target = jnp.asarray(batch["pids"])
    jloss_fn, _ = jax_make_loss(jcfg, NC)
    loss_fn, _ = make_loss(tcfg, NC)
    text = juni.precompute_text_features(jcfg, jmodel, variables, NC) if uniprompt else None
    text_t = precompute_text_features(tcfg, tmodel, NC) if uniprompt else None

    def inner(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x, target, train=True, mutable=["batch_stats"])
        if uniprompt:
            logits = jnp.dot(out["img_feature_proj"].astype(jnp.float32),
                             jnp.asarray(text, jnp.float32).T)
            return jloss_fn(out["scores"][0], out["feats"][1], target, None, logits), mut
        return jloss_fn(out["scores"], out["feats"], target, None), mut

    (jloss, jmut), jg = jax.value_and_grad(inner, has_aux=True)(variables["params"])
    ref_g = from_jax_variables({"params": jg, "batch_stats": jmut["batch_stats"]}, tclip)
    opt = make_optimizer(tsolver, tmodel, stage=stage)
    loss, _, grads, _ = loss_and_grads(tmodel, tcfg, loss_fn, opt, _t(np.asarray(x)),
                                       _t(batch["pids"]).long(), text_features=text_t)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert "classifier.weight" in grads and _np(grads["classifier.weight"]).any()
    _assert_grads_close(grads, ref_g)

    tmodel.load_state_dict(from_jax_variables(variables, tclip), strict=True)
    opt = make_optimizer(tsolver, tmodel, stage=stage)
    state = initial_state(tmodel, opt)
    step = make_train_step(tmodel, tcfg, loss_fn, opt, uniprompt=uniprompt, text_features=text_t)
    state, metrics = step(state, batch, lr, torch.Generator().manual_seed(0))
    jopt = jax_make_optimizer(solver, variables["params"], stage=stage)
    jstep = jsteps.make_train_step(jmodel, jcfg, jloss_fn, jopt, uniprompt=uniprompt,
                                   text_features=None if text is None else jnp.asarray(text))
    jstate, jm = jstep(jax_initial_state(variables, jopt),
                       {k: jnp.asarray(v) for k, v in batch.items()}, lr, jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jloss))
    assert float(metrics["acc"]) == float(jm["acc"])
    ref_p = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats},
                               tclip)
    _assert_params_close(tmodel, ref_p, lr, opt, from_jax_variables(variables, tclip), grads,
                         ref_g)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def market(tmp_path_factory):
    root = tmp_path_factory.mktemp("m1501_margin")
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    return str(root)


TINY = ["MODEL.DEVICE", "cpu", "MODEL.DEBUG_TINY", "True", "INPUT.SIZE_TRAIN", "[32,16]",
        "INPUT.SIZE_TEST", "[32,16]", "TPU.COMPUTE_DTYPE", "float32",
        "DATALOADER.NUM_WORKERS", "2", "TEST.IMS_PER_BATCH", "16"]


@pytest.mark.parametrize("kind", KINDS)
def test_train_entry_with_cos_layer_on_the_cpu(kind, market, tmp_path):
    """python -m mpreid_tpu_torch.train with MODEL.COS_LAYER: two epochs,
    validated; the checkpoint's classifier is the margin head's weight."""
    from mpreid_tpu_torch import train as entry
    from mpreid_tpu_torch.utils.checkpoint import load_checkpoint

    config = os.path.join(REPO, "configs", "person", "vit_base.yml")
    state, history = entry.main(["--config_file", config, *TINY, "MODEL.COS_LAYER", "True",
                                 "MODEL.COS_LAYER_TYPE", kind,
                                 "SOLVER.IMS_PER_BATCH", "8", "SOLVER.MAX_EPOCHS", "2",
                                 "SOLVER.CHECKPOINT_PERIOD", "2", "SOLVER.EVAL_PERIOD", "2",
                                 "DATASETS.ROOT_DIR", market, "OUTPUT_DIR", str(tmp_path)])
    assert isinstance(state.model.classifier, MarginHead) and state.model.classifier.kind == kind
    assert [h["epoch"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    payload = load_checkpoint(str(tmp_path / "ViT-B-16_2.pth"))
    torch.testing.assert_close(payload["model"]["classifier.weight"],
                               state.model.classifier.weight.detach(), atol=0, rtol=0)


@pytest.fixture(scope="module")
def mmmp(tmp_path_factory):
    from mpreid_tpu_torch.data.synthetic import make_mmmp

    root = tmp_path_factory.mktemp("mmmp_margin")
    make_mmmp(str(root))
    return str(root)


def test_train_uniprompt_entry_with_cos_layer_on_the_cpu(mmmp, tmp_path, monkeypatch):
    """python -m mpreid_tpu_torch.train_uniprompt with MODEL.COS_LAYER:
    stages 1a → 1b → 2a → 2b → inference; stage 2's scores come from the
    margin heads, with the labels."""
    from mpreid_tpu_torch import train_uniprompt

    calls = []
    forward = MarginHead.forward

    def counted(self, features, labels=None):
        calls.append(labels is not None)
        return forward(self, features, labels)

    monkeypatch.setattr(MarginHead, "forward", counted)
    stages = ["SOLVER.STAGE1A.MAX_EPOCHS", "1", "SOLVER.STAGE1B.MAX_EPOCHS", "1",
              "SOLVER.STAGE2.MAX_EPOCHS", "1", "SOLVER.STAGE1A.IMS_PER_BATCH", "16",
              "SOLVER.STAGE1B.IMS_PER_BATCH", "16", "SOLVER.STAGE2.IMS_PER_BATCH", "8",
              "SOLVER.STAGE2.EVAL_PERIOD", "1", "SOLVER.STAGE2.CHECKPOINT_PERIOD", "1"]
    config = os.path.join(REPO, "configs", "ours", "cctv_ir_cctv_rgb.yml")
    rank1, rank5 = train_uniprompt.main(["--config_file", config, *TINY, *stages,
                                         "MODEL.COS_LAYER", "True",
                                         "MODEL.COS_LAYER_TYPE", "amsoftmax",
                                         "DATASETS.ROOT_DIR", mmmp, "OUTPUT_DIR", str(tmp_path)])
    assert 0.0 <= rank1 <= rank5 <= 1.0
    assert calls and all(calls)  # two heads a stage-2 step, each given the labels
    sd = torch.load(tmp_path / "exp_cctv_ir_cctv_rgb" / "ViT-B-16_1.pth")["model"]
    assert torch.isfinite(sd["classifier_proj.weight"]).all()


def test_model_factory_builds_margin_heads():
    _, tcfg = _cfg()
    tcfg.MODEL.DEBUG_TINY = True
    tcfg.MODEL.COS_LAYER, tcfg.MODEL.COS_LAYER_TYPE = True, "circle"
    model = make_model(tcfg, NC, 6, 1)
    assert all(isinstance(h, MarginHead) and h.kind == "circle"
               for h in (model.classifier, model.classifier_proj))
    assert float(model.classifier.weight.std()) < 0.01  # normal(0.001) init
