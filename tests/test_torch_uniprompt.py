"""The port's Uni-Prompt slice (mpreid_tpu_torch) against the JAX package's.

Weights are the JAX package's own (its init, perturbed from a numpy seed so
that biases, BN statistics, contexts and adapters are not trivial), carried
across with ``from_jax_variables``. The CLIP is tiny (2 layers, 64 wide, one
text head; and a case with 2 × 64 vision and text heads, whose head-major
storage the converter must undo) and runs in fp32 on the CPU.

Tolerances, fp32: values to 1e-5 relative (the frameworks sum in other
orders), features to 1e-4 absolute after a tower (as tests/test_torch_model.py);
gradients per leaf to a norm-relative 1e-4, floored at 1e-3 of the largest
leaf's (tests/test_torch_train.py); BN statistics to 1e-6; parameters after
an Adam step to 0.25·lr·mult (an element whose gradient is near eps moves
by a fraction of lr that rounding can change), with up to one element in
10⁴ of a leaf, and one in any leaf, allowed 2·lr·mult (a gradient within
rounding of zero can change sign, and Adam's first step is about
lr·sign(g)).
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine import uniprompt as juni
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.losses import supcon_loss as jax_supcon_loss
from mpreid_tpu.models.convert import export_reid_state_dict
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUniPromptReID
from mpreid_tpu.models.uniprompt import view_to_platform_modality as jax_view_map
from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
from mpreid_tpu.solver import make_scheduler as jax_make_scheduler
from mpreid_tpu.solver import optim as joptim
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    do_train_stage1, initial_state, loss_and_grads, make_stage1_step, make_train_step,
    precompute_text_features, stage1_loss_and_grads,
)
from mpreid_tpu_torch.losses import make_loss, supcon_loss
from mpreid_tpu_torch.models import (
    CLIPConfig, UniPromptReID, from_jax_variables, load_param, prompt_template_tokens,
    view_to_platform_modality,
)
from mpreid_tpu_torch.solver import make_optimizer, make_scheduler, stage_trainable

from tiny import tiny_cfg, tiny_clip_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC = 8
SEED = 0


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


def _cfg(**overrides):
    jcfg = tiny_cfg(**{"INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                       "SOLVER.STAGE2.WEIGHT_DECAY": 1e-4, "SOLVER.STAGE2.WEIGHT_DECAY_BIAS": 1e-4,
                       "SOLVER.STAGE2.BIAS_LR_FACTOR": 2, "SOLVER.STAGE1A.IMS_PER_BATCH": 8,
                       "SOLVER.STAGE1B.IMS_PER_BATCH": 8, **overrides})
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_model(heads, lora_rank, layout):
    """(clip config, JAX model, perturbed variables as numpy), built once
    per configuration (the JAX init is the slow part)."""
    width = 64 * heads
    clip = tiny_clip_config(vision_width=width, transformer_width=width,
                            transformer_heads=heads, lora_rank=lora_rank,
                            vision_layout=layout, text_layout=layout)
    jmodel = JaxUniPromptReID(clip_config=clip, num_classes=NC, camera_num=14, view_num=1)
    variables = _perturb(init_variables(jmodel, jax.random.PRNGKey(0), _cfg()[0]), SEED)
    return clip, jmodel, variables


class Pair:
    """A JAX Uni-Prompt model with perturbed variables and the port's twin."""

    def __init__(self, heads=1, lora_rank=0, layout=""):
        self.clip, self.jmodel, self.variables = _jax_model(heads, lora_rank, layout)
        self.jcfg, self.tcfg = _cfg()
        self.tclip = CLIPConfig(**dataclasses.asdict(self.clip))
        self.keep_lora = bool(lora_rank)
        self.tmodel = UniPromptReID(self.tclip, NC, camera_num=14, view_num=1).eval()
        self.load(self.variables)

    def convert(self, variables):
        return from_jax_variables(variables, self.tclip, keep_lora=self.keep_lora)

    def load(self, variables):
        self.tmodel.load_state_dict(self.convert(variables), strict=True)

    def apply(self, *args, method=None, variables=None, **kwargs):
        return self.jmodel.apply(variables or self.variables, *args, method=method, **kwargs)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def pair2():
    """Two vision and two text heads, head-major storage in JAX."""
    return Pair(heads=2)


def _images(n=8, seed=1, hw=(32, 16)):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _normalized(images, cfg):
    from mpreid_tpu.ops import augment as jaug

    return np.asarray(jaug.eval_preprocess(jnp.asarray(images), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                                           std=tuple(cfg.INPUT.PIXEL_STD)))


# ---------------------------------------------------------------------------
# conversion and parameter groups (faults 1 and 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,layout,lora", [(1, "", 0), (2, "", 0), (2, "packed", 0),
                                               (2, "", 4)])
def test_from_jax_variables_equals_export(heads, layout, lora):
    """A JAX Uni-Prompt tree loads through from_jax_variables (it refused
    every one before), equal to the JAX package's reference export key for
    key, plus the text tower's token embedding, which the export leaves out."""
    p = Pair(heads=heads, layout=layout, lora_rank=lora)
    want = export_reid_state_dict(p.variables, p.jmodel)
    got = from_jax_variables(p.variables, p.tclip)  # adapters folded, as the export does
    assert set(got) == set(want) | {"text_encoder.token_embedding.weight"}
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    np.testing.assert_array_equal(
        got["text_encoder.token_embedding.weight"].numpy(),
        np.asarray(p.variables["params"]["text"]["token_embedding"]["embedding"]))


@pytest.mark.parametrize("stage", ["baseline", "stage1a", "stage1b", "stage2a", "stage2b", "lora"])
def test_stage_trainable_matches_jax_for_every_leaf(stage):
    """The JAX package's trainable flag of every parameter, carried to torch
    names (each leaf filled with its flag), against the port's: stage 2a
    freezes the text tower (``text_encoder``, JAX's ``text``)."""
    p = Pair(heads=2, lora_rank=4)
    params = p.variables["params"]
    jtrain = joptim.stage_trainable(params, stage)
    ttrain = stage_trainable(p.tmodel, stage)
    assert set(ttrain) == {n for n, _ in p.tmodel.named_parameters()}
    filled = jax.tree_util.tree_map(lambda x, v: np.full(np.shape(x), float(v), np.float32),
                                    params, jtrain)
    carried = p.convert({"params": filled, "batch_stats": p.variables["batch_stats"]})
    for name, flag in ttrain.items():
        assert np.unique(_np(carried[name])).tolist() == [float(flag)], name
    if stage == "stage2a":
        assert not any(f for n, f in ttrain.items() if n.startswith("text_encoder."))


def test_load_param_reads_a_reference_uniprompt_pth(pair, tmp_path):
    """A reference-layout .pth: strict on its keys; the token embedding stays
    as initialised and the derived prefix/suffix buffers are ignored."""
    sd = export_reid_state_dict(pair.variables, pair.jmodel)
    sd["prompt_learner.token_prefix"] = torch.zeros(1, 1, 64)
    sd["prompt_learner.token_suffix"] = torch.zeros(1, 60, 64)
    path = str(tmp_path / "uniprompt.pth")
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    model = UniPromptReID(pair.tclip, NC, camera_num=14, view_num=1)
    model.init_(torch.Generator().manual_seed(3))
    emb = model.text_encoder.token_embedding.weight.detach().clone()
    load_param(path, model)
    torch.testing.assert_close(model.text_encoder.token_embedding.weight.detach(), emb,
                               atol=0, rtol=0)
    for k, v in sd.items():
        if not k.startswith("prompt_learner.token_"):
            torch.testing.assert_close(model.state_dict()[k], v, atol=0, rtol=0, msg=k)
    del sd["visual_prompt"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="visual_prompt"):
        load_param(path, model)


# ---------------------------------------------------------------------------
# the text tower, the prompts and the forwards
# ---------------------------------------------------------------------------

def test_prompt_template_and_view_map_match_jax():
    from mpreid_tpu.models.uniprompt import prompt_template_tokens as jax_template

    np.testing.assert_array_equal(prompt_template_tokens(), jax_template())
    views = np.arange(15, dtype=np.int32)
    for got, want in zip(view_to_platform_modality(_t(views)), jax_view_map(jnp.asarray(views))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["pair", "pair2"])
def test_text_tower_matches_jax(which, request):
    p = request.getfixturevalue(which)
    from mpreid_tpu.models.tokenizer import tokenize

    tokens = tokenize(["a photo of a person.", "X X X X person.", "uav thermal camera 14"])
    want = p.apply(jnp.asarray(tokens), method=lambda m, t: m.text_encoder.encode_tokens(t))
    with torch.no_grad():
        got = p.tmodel.text_encoder.encode_tokens(_t(tokens).long())
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    width = p.clip.transformer_width
    emb = np.random.default_rng(4).standard_normal((3, 77, width)).astype(np.float32) * 0.1
    template = prompt_template_tokens()
    want = p.apply(jnp.asarray(emb), jnp.asarray(template),
                   method=lambda m, e, t: m.text_encoder.encode_embeddings(e, t))
    with torch.no_grad():
        got = p.tmodel.text_encoder.encode_embeddings(_t(emb), _t(template).long())
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("which", ["pair", "pair2"])
@pytest.mark.parametrize("stage,with_view", [("1a", False), ("1a", True), ("1b", True),
                                             ("1b", False), ("2", True), ("2", False)])
def test_get_text_matches_jax(which, stage, with_view, request):
    """Every stage, with the view-selected contexts over views 0-14 and
    with the mean contexts (no view)."""
    p = request.getfixturevalue(which)
    labels = np.random.default_rng(5).integers(0, NC, 15).astype(np.int32)
    views = np.arange(15, dtype=np.int32)
    jviews = jnp.asarray(views) if with_view else None
    want = p.apply(jnp.asarray(labels), jviews, stage, method=JaxUniPromptReID.get_text)
    with torch.no_grad():
        got = p.tmodel.get_text(_t(labels).long(), _t(views).long() if with_view else None, stage)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("lora", [0, 4])
def test_forward_train_and_eval_match_jax(lora):
    """forward_train (all outputs, BN statistics) and forward_eval, with
    LoRA adapters off and on (carried as parameters, not folded)."""
    p = Pair(heads=2, lora_rank=lora)
    x = _normalized(_images(), p.jcfg)
    want = p.apply(jnp.asarray(x), train=False)
    with torch.no_grad():
        got = p.tmodel.forward_eval(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)
    labels = np.repeat(np.arange(2), 4).astype(np.int32)
    out, mut = p.apply(jnp.asarray(x), jnp.asarray(labels), train=True, mutable=["batch_stats"])
    got = p.tmodel.forward_train(_t(x), _t(labels).long())
    for key in ("scores", "feats"):
        for g, w in zip(got[key], out[key]):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=1e-4)
    for key in ("img_feature_proj", "image_features_proj_raw"):
        np.testing.assert_allclose(_np(got[key]), _np(out[key]), atol=1e-4, rtol=0)
    ref = p.convert({"params": p.variables["params"], "batch_stats": mut["batch_stats"]})
    for name in ("bottleneck.running_mean", "bottleneck_proj.running_var"):
        np.testing.assert_allclose(_np(p.tmodel.state_dict()[name]), _np(ref[name]), atol=1e-6)


def test_image_and_fusion_forwards_match_jax(pair2):
    p = pair2
    x = _normalized(_images(4), p.jcfg)
    with torch.no_grad():
        for name in ("get_image", "get_image_vp", "get_more_image"):
            want = p.apply(jnp.asarray(x), method=getattr(JaxUniPromptReID, name))
            got = getattr(p.tmodel, name)(_t(x))
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                np.testing.assert_allclose(_np(g), _np(w), atol=1e-4, rtol=0)
        rng = np.random.default_rng(6)
        img, txt = (rng.standard_normal((4, 32)).astype(np.float32) for _ in range(2))
        want = p.apply(jnp.asarray(img), jnp.asarray(txt), method=JaxUniPromptReID.get_image_update)
        np.testing.assert_allclose(_np(p.tmodel.get_image_update(_t(img), _t(txt))), _np(want),
                                   atol=1e-5, rtol=0)
        want = p.apply(jnp.asarray(txt), method=lambda m, t: m.prompt_learner.visual_enhanced(t))
        np.testing.assert_allclose(_np(p.tmodel.prompt_learner.visual_enhanced(_t(txt))),
                                   _np(want), atol=1e-5, rtol=0)


def test_lora_starts_as_the_identity():
    """lora_b starts at zero: a model with adapters computes what the same
    weights without them compute."""
    jcfg, tcfg = _cfg(**{"MODEL.DEBUG_TINY": True, "SOLVER.LORA.ENABLED": True,
                         "SOLVER.LORA.LORA_R": 4})
    from mpreid_tpu_torch.models import make_model_uniprompt

    tcfg.MODEL.DEBUG_TINY = True
    tcfg.SOLVER.LORA.ENABLED, tcfg.SOLVER.LORA.LORA_R = True, 4
    with_lora = make_model_uniprompt(tcfg, NC, 14, 1)
    without = UniPromptReID(dataclasses.replace(with_lora.clip_config, lora_rank=0), NC, 14, 1)
    sd = {k: v for k, v in with_lora.state_dict().items() if "lora" not in k}
    without.load_state_dict(sd, strict=True)
    x = _t(_normalized(_images(2), jcfg))
    with torch.no_grad():
        torch.testing.assert_close(with_lora.forward_eval(x), without.eval().forward_eval(x),
                                   atol=1e-6, rtol=0)
        labels = torch.arange(2)
        torch.testing.assert_close(with_lora.get_text(labels), without.get_text(labels),
                                   atol=1e-6, rtol=0)
    assert {n for n, f in stage_trainable(with_lora, "lora").items() if f} == {
        n for n, _ in with_lora.named_parameters() if n.split(".")[-1].startswith("lora")}


# ---------------------------------------------------------------------------
# stage 1: one step and a whole epoch loop
# ---------------------------------------------------------------------------

def _bank(n, dim=32, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, dim)).astype(np.float32),
            rng.integers(0, NC, n).astype(np.int32), rng.integers(0, 15, n).astype(np.int32))


def test_supcon_matches_jax():
    rng = np.random.default_rng(8)
    a, b = (rng.standard_normal((6, 16)).astype(np.float32) for _ in range(2))
    labels = np.array([0, 1, 0, 2, 1, 3], np.int32)
    jl = jnp.asarray(labels)
    jv, (jga, jgb) = jax.value_and_grad(lambda x, y: jax_supcon_loss(x, y, jl, jl),
                                        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(True), _t(b).requires_grad_(True)
    tv = supcon_loss(ta, tb, _t(labels), _t(labels))
    tv.backward()
    assert abs(float(tv.detach()) - float(jv)) <= 1e-5 * abs(float(jv))
    np.testing.assert_allclose(_np(ta.grad), _np(jga), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(tb.grad), _np(jgb), rtol=1e-5, atol=1e-6)


def _assert_params_close(tmodel, ref, lr, mult=None):
    """Parameters after an Adam step to 0.25·lr·mult; an element whose
    gradient is within rounding of zero may step the other way, so up to one
    element in 10⁴ of a leaf, and one in any leaf, may differ by up to
    2·lr·mult."""
    for name, param in tmodel.named_parameters():
        unit = lr * (mult.get(name, 1.0) if mult else 1.0)
        err = np.abs(_np(param) - _np(ref[name]))
        assert (err > 0.25 * unit).sum() <= max(1, err.size // 10_000), (
            name, float(err.max()), unit)
        assert float(err.max()) <= 2 * unit, (name, float(err.max()), unit)


@pytest.mark.parametrize("stage", ["1a", "1b"])
def test_stage1_step_matches_jax(stage):
    """Loss, the contexts' gradients and every parameter after one step,
    against make_stage1_step; the contexts of labels outside the batch get a
    zero gradient and still decay (coupled L2)."""
    p = Pair(heads=2)
    feats, labels, views = _bank(8)
    views_j = jnp.asarray(views) if stage == "1b" else None
    stage_cfg = p.jcfg.SOLVER[f"STAGE{stage.upper()}"]
    lr = 1e-3
    params = p.variables["params"]

    def jloss(prm):
        text = p.jmodel.apply({"params": prm, "batch_stats": p.variables["batch_stats"]},
                              jnp.asarray(labels), views_j, stage,
                              method=JaxUniPromptReID.get_text)
        f, t = jnp.asarray(feats), jnp.asarray(labels)
        return jax_supcon_loss(f, text, t, t) + jax_supcon_loss(text, f, t, t)

    jl, jg = jax.value_and_grad(jloss)(params)
    opt = make_optimizer(stage_cfg, p.tmodel, stage=f"stage{stage}")
    loss, grads = stage1_loss_and_grads(p.tmodel, opt, stage, _t(feats), _t(labels).long(),
                                        _t(views).long() if stage == "1b" else None)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want = {"1a": ("ctx_generic",), "1b": ("ctx_modality", "ctx_platform")}[stage]
    assert set(grads) == {f"prompt_learner.{n}" for n in want}
    for n in want:
        g, w = _np(grads[f"prompt_learner.{n}"]), _np(jg["prompt_learner"][n])
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), n
    if stage == "1a":
        absent = sorted(set(range(NC)) - set(labels.tolist()))
        assert absent and not np.abs(_np(grads["prompt_learner.ctx_generic"])[absent]).any()

    jopt = jax_make_optimizer(stage_cfg, params, stage=f"stage{stage}")
    jstate = jax_initial_state(p.variables, jopt)
    jstate, jm = jsteps.make_stage1_step(p.jmodel, p.jcfg, jopt, stage)(
        jstate, jnp.asarray(feats), jnp.asarray(labels), views_j, lr)
    state = initial_state(p.tmodel, opt)
    state, metrics = make_stage1_step(p.tmodel, p.tcfg, opt, stage)(
        state, _t(feats), _t(labels), _t(views) if stage == "1b" else None, lr)
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jl))
    ref = p.convert({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_params_close(p.tmodel, ref, lr)
    before = p.convert(p.variables)
    for n, param in p.tmodel.named_parameters():
        if not n.startswith("prompt_learner.ctx"):
            np.testing.assert_array_equal(_np(param), _np(before[n]), err_msg=n)


@pytest.mark.parametrize("is_stage1b", [False, True])
def test_do_train_stage1_matches_jax(is_stage1b):
    """Two epochs of 20 bank rows at batch 8 (two full batches and a trailing
    partial one each): the loss history and the final contexts."""
    p = Pair()
    bank = _bank(20)
    name = "STAGE1B" if is_stage1b else "STAGE1A"
    for cfg in (p.jcfg, p.tcfg):
        cfg.SOLVER[name].MAX_EPOCHS = 2
        cfg.SOLVER[name].BASE_LR = 1e-3
        cfg.SOLVER[name].WARMUP_EPOCHS = 0
        cfg.OUTPUT_DIR = ""
    stage = "stage1b" if is_stage1b else "stage1a"
    params = p.variables["params"]
    jopt = jax_make_optimizer(p.jcfg.SOLVER[name], params, stage=stage)
    jvars, jhist = juni.do_train_stage1(
        p.jcfg, p.jmodel, p.variables, None, jopt,
        jax_make_scheduler(p.jcfg.SOLVER[name], "cosine"), is_stage1b=is_stage1b,
        bank=bank, stage_cfg=p.jcfg.SOLVER[name])
    opt = make_optimizer(p.tcfg.SOLVER[name], p.tmodel, stage=stage)
    state, hist = do_train_stage1(
        p.tcfg, p.tmodel, None, opt, make_scheduler(p.tcfg.SOLVER[name], "cosine"),
        is_stage1b=is_stage1b, bank=(_t(bank[0]), bank[1], bank[2]),
        stage_cfg=p.tcfg.SOLVER[name])
    assert state.opt_state.step == 6
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist] == [1, 2]
    for h, jh in zip(hist, jhist):
        assert abs(h["loss"] - jh["loss"]) <= 1e-5 * abs(jh["loss"])
    ref = p.convert(jvars)
    lr = p.tcfg.SOLVER[name].BASE_LR
    for n in ("ctx_generic", "ctx_modality", "ctx_platform"):
        key = f"prompt_learner.{n}"
        err = float(np.abs(_np(p.tmodel.state_dict()[key]) - _np(ref[key])).max())
        assert err <= 0.25 * lr, (key, err)


# ---------------------------------------------------------------------------
# stage 2: the text features and one stage-2a step
# ---------------------------------------------------------------------------

def test_precompute_text_features_matches_jax(pair2):
    p = pair2
    want = juni.precompute_text_features(p.jcfg, p.jmodel, p.variables, NC, batch=3)
    got = precompute_text_features(p.tcfg, p.tmodel, NC, batch=3)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=1e-4, rtol=0)


UNUSED_IN_STAGE2A = ("classifier_proj.weight", "bottleneck_proj.weight", "visual_prompt",
                     "image_fusion_net.fc1.weight", "image_fusion_net.fc1.bias",
                     "image_fusion_net.fc2.weight", "image_fusion_net.fc2.bias")


def test_stage2a_step_matches_jax():
    """One stage-2a step from the same weights, augmentation off: loss, acc
    (from the i2t logits), every gradient (zero for the trainable leaves the
    loss does not reach, as jax.value_and_grad gives them), the BN
    statistics and every parameter after the step: the unused leaves move by
    the coupled L2 as JAX's do, and the text tower stays as it was."""
    p = Pair(heads=2)
    batch = {"images": _images(8, seed=3), "pids": np.repeat(np.arange(2), 4).astype(np.int32),
             "camids": np.zeros(8, np.int32), "trackids": np.zeros(8, np.int32)}
    lr = 1e-3
    s2 = p.jcfg.SOLVER.STAGE2
    text = juni.precompute_text_features(p.jcfg, p.jmodel, p.variables, NC)
    x = jnp.asarray(_normalized(batch["images"], p.jcfg))
    target = jnp.asarray(batch["pids"])
    jloss_fn, _ = jax_make_loss(p.jcfg, NC)

    def inner(params):
        out, mut = p.jmodel.apply({"params": params, "batch_stats": p.variables["batch_stats"]},
                                  x, target, train=True, mutable=["batch_stats"])
        logits = jnp.dot(out["img_feature_proj"].astype(jnp.float32),
                         jnp.asarray(text, jnp.float32).T)
        return jloss_fn(out["scores"][0], out["feats"][1], target, None, logits), mut

    (jloss, jmut), jg = jax.value_and_grad(inner, has_aux=True)(p.variables["params"])
    ref_g = p.convert({"params": jg, "batch_stats": jmut["batch_stats"]})

    loss_fn, _ = make_loss(p.tcfg, NC)
    opt = make_optimizer(p.tcfg.SOLVER.STAGE2, p.tmodel, stage="stage2a")
    text_t = precompute_text_features(p.tcfg, p.tmodel, NC)
    loss, acc, grads, _ = loss_and_grads(p.tmodel, p.tcfg, loss_fn, opt, _t(np.asarray(x)),
                                         _t(batch["pids"]).long(), text_features=text_t)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(grads) == {n for n, f in opt.trainable.items() if f}
    assert not any(n.startswith(("text_encoder.", "prompt_learner.")) for n in grads)
    floor = 1e-3 * max(float(np.linalg.norm(_np(ref_g[n]))) for n in grads)
    for name, g in grads.items():
        diff = float(np.linalg.norm(_np(g) - _np(ref_g[name])))
        assert diff <= 1e-4 * max(float(np.linalg.norm(_np(ref_g[name]))), floor), name
    for name in UNUSED_IN_STAGE2A:
        assert not _np(grads[name]).any() and not _np(ref_g[name]).any(), name
    for name in ("bottleneck.running_mean", "bottleneck.running_var"):
        np.testing.assert_allclose(_np(p.tmodel.state_dict()[name]), _np(ref_g[name]), atol=1e-6)

    # the step itself, through both packages' make_train_step
    p.load(p.variables)
    state = initial_state(p.tmodel, opt)
    step = make_train_step(p.tmodel, p.tcfg, loss_fn, opt, uniprompt=True, text_features=text_t)
    state, metrics = step(state, batch, lr, torch.Generator().manual_seed(0))
    jopt = jax_make_optimizer(s2, p.variables["params"], stage="stage2a")
    jstate = jax_initial_state(p.variables, jopt)
    jstep = jsteps.make_train_step(p.jmodel, p.jcfg, jloss_fn, jopt, uniprompt=True,
                                   text_features=jnp.asarray(text))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, lr,
                       jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jloss))
    assert float(metrics["acc"]) == float(jm["acc"])
    ref_p = p.convert({"params": jstate.params, "batch_stats": jstate.batch_stats})
    _assert_params_close(p.tmodel, ref_p, lr, opt.lr_mult)
    before = p.convert(p.variables)
    for name in UNUSED_IN_STAGE2A:
        assert not np.array_equal(_np(p.tmodel.state_dict()[name]), _np(before[name])), name
    for name, param in p.tmodel.named_parameters():
        if name.startswith("text_encoder."):
            np.testing.assert_array_equal(_np(param), _np(before[name]), err_msg=name)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mmmp(tmp_path_factory):
    from mpreid_tpu_torch.data.synthetic import make_mmmp

    root = tmp_path_factory.mktemp("mmmp")
    make_mmmp(str(root))
    return str(root)


def test_make_mmmp_writes_the_jax_packages_tree(mmmp, tmp_path):
    from mpreid_tpu.data.synthetic import make_mmmp as jax_make_mmmp

    jax_make_mmmp(str(tmp_path))
    mine = sorted(os.path.relpath(os.path.join(d, f), mmmp)
                  for d, _, fs in os.walk(mmmp) for f in fs)
    theirs = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                    for d, _, fs in os.walk(tmp_path) for f in fs)
    assert mine == theirs
    for rel in mine[:5] + mine[-5:]:
        with open(os.path.join(mmmp, rel), "rb") as a, open(tmp_path / rel, "rb") as b:
            assert a.read() == b.read(), rel


TINY_ARGS = ["MODEL.DEVICE", "cpu", "MODEL.DEBUG_TINY", "True",
             "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
             "TPU.COMPUTE_DTYPE", "float32", "DATALOADER.NUM_WORKERS", "2",
             "TEST.IMS_PER_BATCH", "16"]
STAGE_ARGS = ["SOLVER.STAGE1A.MAX_EPOCHS", "1", "SOLVER.STAGE1B.MAX_EPOCHS", "1",
              "SOLVER.STAGE2.MAX_EPOCHS", "1", "SOLVER.STAGE1A.CHECKPOINT_PERIOD", "1",
              "SOLVER.STAGE1B.CHECKPOINT_PERIOD", "1", "SOLVER.STAGE2.CHECKPOINT_PERIOD", "1",
              "SOLVER.STAGE2.EVAL_PERIOD", "1", "SOLVER.STAGE1A.IMS_PER_BATCH", "16",
              "SOLVER.STAGE1B.IMS_PER_BATCH", "16", "SOLVER.STAGE1.IMS_PER_BATCH", "16",
              "SOLVER.STAGE2.IMS_PER_BATCH", "8"]


def test_train_and_test_cli_on_the_cpu(mmmp, tmp_path):
    """python -m mpreid_tpu_torch.train_uniprompt runs 1a → 1b → 2a → 2b →
    inference; python -m mpreid_tpu_torch.test_uniprompt loads its checkpoint."""
    env = dict(os.environ, PYTHONPATH=REPO)
    cfg_file = os.path.join(REPO, "configs", "ours", "cctv_ir_cctv_rgb.yml")
    cmd = [sys.executable, "-m", "mpreid_tpu_torch.train_uniprompt", "--config_file", cfg_file,
           *TINY_ARGS, *STAGE_ARGS, "DATASETS.ROOT_DIR", mmmp, "OUTPUT_DIR", str(tmp_path)]
    out = subprocess.run(cmd, cwd=str(tmp_path), capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    for text in ("Start training stage 1a", "Start training stage 1b", "2a stage", "2b stage",
                 "Epoch 1 done", "Enter inferencing"):
        assert text in out.stdout, text
    ckpt = tmp_path / "exp_cctv_ir_cctv_rgb" / "ViT-B-16_1.pth"
    assert ckpt.exists()
    assert (tmp_path / "ViT-B-16_stage1a_1.pth").exists()
    assert (tmp_path / "ViT-B-16_stage1b_1.pth").exists()
    cmd = [sys.executable, "-m", "mpreid_tpu_torch.test_uniprompt", "--config_file", cfg_file,
           *TINY_ARGS, "DATASETS.ROOT_DIR", mmmp, "TEST.WEIGHT", str(ckpt),
           "OUTPUT_DIR", str(tmp_path / "test")]
    out = subprocess.run(cmd, cwd=str(tmp_path), capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "Loading pretrained model" in out.stdout and "Rank-1" in out.stdout


def test_entry_points_refuse_what_is_not_ported(mmmp, tmp_path):
    """MODEL.MOE.ENABLED (it raised until the MoE tower was ported) runs the
    pipeline to its end, upcycling after stage 1b, and test_uniprompt loads
    the MoE checkpoint strictly; TEST.TTA_ENABLED and TEST.TTPT.ENABLED
    (they raised until the eval modes were ported) run through
    test_uniprompt and return the ranks of a direct do_inference_ttpt call
    on the same seeded model."""
    from mpreid_tpu_torch import test_uniprompt, train_uniprompt

    moe = ["MODEL.MOE.ENABLED", "True", "MODEL.MOE.NUM_EXPERTS", "4", "MODEL.MOE.TOP_K", "2",
           "MODEL.MOE.MOE_LAYERS", "2"]
    rank1, rank5 = train_uniprompt.main([*TINY_ARGS, *STAGE_ARGS, "DATASETS.ROOT_DIR", mmmp,
                                         "OUTPUT_DIR", str(tmp_path), *moe])
    assert 0.0 <= rank1 <= rank5 <= 1.0
    ckpt = tmp_path / "exp_cctv_ir_cctv_rgb" / "ViT-B-16_1.pth"
    assert any(".experts.3.c_fc.weight" in k for k in torch.load(ckpt)["model"])
    cfg_file = os.path.join(REPO, "configs", "ours", "cctv_ir_cctv_rgb.yml")
    assert test_uniprompt.main(["--config_file", cfg_file, *TINY_ARGS, "DATASETS.ROOT_DIR",
                                mmmp, *moe, "TEST.WEIGHT", str(ckpt),
                                "OUTPUT_DIR", str(tmp_path / "test")]) == (rank1, rank5)
    from mpreid_tpu_torch.data import make_dataloader
    from mpreid_tpu_torch.engine import do_inference_ttpt
    from mpreid_tpu_torch.models import make_model_uniprompt

    for flag in ("TEST.TTA_ENABLED", "TEST.TTPT.ENABLED"):
        args = [*TINY_ARGS, "DATASETS.ROOT_DIR", mmmp, flag, "True", "TEST.TTPT.STEPS", "2",
                "OUTPUT_DIR", str(tmp_path / "tta")]
        ranks = test_uniprompt.main(["--config_file", cfg_file, *args])
        cfg = get_default_cfg()
        cfg.merge_from_file(cfg_file)
        cfg.merge_from_list(args)
        _, _, val, nq, ncls, ncam, nview = make_dataloader(cfg)
        model = make_model_uniprompt(cfg, ncls, ncam, nview, device="cpu")
        assert ranks == do_inference_ttpt(cfg, model, val, nq)
        assert all(0.0 <= r <= 1.0 for r in ranks)
