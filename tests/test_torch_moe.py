"""The port's MoE vision tower and stage 2b (mpreid_tpu_torch) against the JAX package's.

Routing and the load-balancing loss, the expert MLPs, the MoE block, the
MoE tower (``MOE_LAYERS`` 1, 2 and -1, shared routing on and off), the
conversion of an MoE variable tree, upcycling (``switch_to_moe``), the
stage-2b parameter groups and stage-2a/2b train steps, on the same weights
(seeded numpy values in the JAX package's variable trees) and the same
inputs.
The CLIP is the tiny one of ``tests/tiny.py`` (2 layers, 64 wide) in fp32
on the CPU; the MoE has 4 experts, top-2.

Tolerances, fp32: routing weights and forwards to 1e-5 max abs (the two
frameworks sum in other orders), the selected experts equal, losses to
1e-4 relative; gradients per leaf to a norm-relative 1e-4, the reference
norm floored at 1e-3 of the largest leaf's (tests/test_torch_train.py);
parameters after an Adam step as tests/test_torch_uniprompt.py holds them.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpreid_tpu.engine import steps as jsteps
from mpreid_tpu.engine import uniprompt as juni
from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
from mpreid_tpu.losses import make_loss as jax_make_loss
from mpreid_tpu.models import moe as jmoe
from mpreid_tpu.models.convert import export_reid_state_dict
from mpreid_tpu.models.factory import init_variables
from mpreid_tpu.models.factory import switch_to_moe as jax_switch_to_moe
from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUniPromptReID
from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
from mpreid_tpu.solver import optim as joptim
from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    initial_state, loss_and_grads, make_train_step, precompute_text_features,
)
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import (
    CLIPConfig, ExpertMLPs, MoEResidualAttentionBlock, ReIDModel, UniPromptReID,
    from_jax_variables, load_balancing_loss, load_param, switch_to_moe, topk_routing,
)
from mpreid_tpu_torch.models.convert import _block
from mpreid_tpu_torch.solver import make_optimizer, stage_trainable

from tiny import tiny_cfg, tiny_clip_config

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

NC = 8
E, TOP_K = 4, 2
MOE = {"MODEL.MOE.ENABLED": True, "MODEL.MOE.NUM_EXPERTS": E, "MODEL.MOE.TOP_K": TOP_K,
       "MODEL.MOE.MOE_LAYERS": 2}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _seeded(variables, seed=0):
    """Seeded numpy values in the structure of a JAX variable tree (an
    abstract init: the JAX package's eager init of a Uni-Prompt model takes
    half a minute on the CPU). Kernels and projections ~ N(0, fan_in^-1),
    scales 1 + N(0, 0.05²), biases, embeddings and contexts ~ N(0, 0.05²);
    BN variances in [0.5, 1.5], means ~ N(0, 0.1²)."""
    rng = np.random.default_rng(seed)

    def params(path, x):
        name, shape = path[-1].key, np.shape(x)
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.05 * n
        if name.endswith("kernel") or name.endswith("proj") or name == "text_projection":
            return n * np.float32(shape[-2] ** -0.5)
        return 0.05 * n

    def stats(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, np.shape(x)).astype(np.float32)
        return 0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(params, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stats, variables["batch_stats"])}


def _cfg(**overrides):
    """The JAX package's config and the port's, equal (augmentation off)."""
    jcfg = tiny_cfg(**{"INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                       "SOLVER.STAGE2.WEIGHT_DECAY": 1e-4, "SOLVER.STAGE2.WEIGHT_DECAY_BIAS": 1e-4,
                       "SOLVER.STAGE2.BIAS_LR_FACTOR": 2, **overrides})
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


def _images(n=8, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 16, 3), dtype=np.uint8)


def _normalized(images, cfg):
    from mpreid_tpu.ops import augment as jaug

    return np.asarray(jaug.eval_preprocess(jnp.asarray(images), mean=tuple(cfg.INPUT.PIXEL_MEAN),
                                           std=tuple(cfg.INPUT.PIXEL_STD)))


# ---------------------------------------------------------------------------
# routing and the load-balancing loss
# ---------------------------------------------------------------------------

def _logits(kind, n=40, e=E, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "all_tie":  # the zero gates of an upcycled model
        return np.zeros((n, e), np.float32)
    x = rng.standard_normal((n, e)).astype(np.float32)
    if kind == "some_ties":  # rows with a tie at the top, and across the k-th place
        x[::3, 1] = x[::3, 0] = x[::3].max(axis=1) + 0.5
        x[1::3, 3] = x[1::3, 2]
    return x


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "all_tie", "some_ties"])
def test_routing_and_balancing_loss_match_jax(kind, top_k):
    logits = _logits(kind)
    jcombine, jsel = jmoe.topk_routing(jnp.asarray(logits), top_k)
    combine, sel = topk_routing(_t(logits), top_k)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(_np(combine), _np(jcombine), atol=1e-6, rtol=0)
    # the loss over a (n_gating, N, E) stack's first block, as the step takes it
    want = float(jmoe.load_balancing_loss(jnp.asarray(logits), top_k))
    got = float(load_balancing_loss(_t(logits), top_k))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    # its gradient with respect to the logits (the gates' gradient through it)
    jg = jax.grad(lambda x: jmoe.load_balancing_loss(x, top_k))(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    load_balancing_loss(x, top_k).backward()
    np.testing.assert_allclose(_np(x.grad), _np(jg), atol=1e-7, rtol=0)


def test_all_tie_routing_picks_the_lowest_experts():
    """Zero gates (an upcycled model at step 0): every token picks experts
    0 and 1 with weight ½ each, as lax.top_k orders ties."""
    combine, sel = topk_routing(torch.zeros(7, E), TOP_K)
    assert sel.tolist() == [[0, 1]] * 7
    assert combine.tolist() == [[0.5, 0.5, 0.0, 0.0]] * 7


# ---------------------------------------------------------------------------
# the expert MLPs and the block
# ---------------------------------------------------------------------------

def _expert_params(experts):
    """The JAX package's ExpertMLPs params → the port's stacked leaves."""
    return {"c_fc_weight": _t(np.transpose(_np(experts["c_fc_kernel"]), (0, 2, 1))),
            "c_fc_bias": _t(_np(experts["c_fc_bias"])),
            "c_proj_weight": _t(np.transpose(_np(experts["c_proj_kernel"]), (0, 2, 1))),
            "c_proj_bias": _t(_np(experts["c_proj_bias"]))}


def test_expert_mlps_match_jax():
    rng = np.random.default_rng(3)
    d, n = 64, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    combine = np.asarray(jmoe.topk_routing(jnp.asarray(_logits("random", n)), TOP_K)[0])
    jexp = jmoe.ExpertMLPs(d, E)
    params = jexp.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(combine))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = jexp.apply({"params": params}, jnp.asarray(x), jnp.asarray(combine))
    texp = ExpertMLPs(d, E)
    texp.load_state_dict(_expert_params(params), strict=False)
    with torch.no_grad():
        got = texp(_t(x), _t(combine))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_expert_dropout_draws_from_the_generator():
    """MOE.DROPOUT in training: flax's inverted dropout, drawn from the
    given generator (the same draws give the same output), off in eval."""
    texp = ExpertMLPs(16, E, dropout=0.5)
    texp.init_(torch.Generator().manual_seed(0))
    x = torch.randn(6, 16, generator=torch.Generator().manual_seed(1))
    combine = topk_routing(torch.randn(6, E), TOP_K)[0]
    a = texp(x, combine, train=True, gen=torch.Generator().manual_seed(5))
    b = texp(x, combine, train=True, gen=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, texp(x, combine))
    with pytest.raises(ValueError, match="Generator"):
        texp(x, combine, train=True)


@pytest.mark.parametrize("given_routing", [False, True])
def test_moe_block_matches_jax(given_routing):
    """Attention, the gate's fp32 logits, the combine weights and the block
    output; with a routing decision given, the block reuses it and returns
    no logits."""
    rng = np.random.default_rng(4)
    d, b, l = 64, 3, 5
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    routing = np.asarray(jmoe.topk_routing(jnp.asarray(_logits("random", b * l, seed=9)),
                                           TOP_K)[0]) if given_routing else None
    jblock = jmoe.MoEResidualAttentionBlock(d, 1, E, TOP_K, layout="packed")
    params = jblock.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = jblock.apply({"params": params}, jnp.asarray(x),
                        routing=None if routing is None else jnp.asarray(routing))
    sd = {}
    _block(params, "b", sd, 16.0, None, False)
    tblock = MoEResidualAttentionBlock(d, 1, E, TOP_K)
    tblock.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tblock(_t(x), routing=None if routing is None else _t(routing))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), atol=1e-5, rtol=0)
    assert (got[1] is None) == (want[1] is None) == given_routing
    if not given_routing:
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), atol=1e-5, rtol=0)
        assert got[1].dtype == torch.float32
    np.testing.assert_allclose(_np(got[2]), _np(want[2]), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the tower and the conversion
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_reid(moe_layers, shared_routing):
    """(JAX clip config, JAX MoE ReID model, perturbed variables), built once
    per configuration (the JAX init is the slow part)."""
    clip = tiny_clip_config(num_experts=E, top_k=TOP_K, moe_layers=moe_layers,
                            shared_routing=shared_routing)
    jmodel = JaxReIDModel(clip_config=clip, num_classes=NC, camera_num=14, view_num=1)
    return clip, jmodel, _seeded(init_variables(jmodel, jax.random.PRNGKey(0), _cfg()[0],
                                                abstract=True))


def _port_reid(clip, variables):
    tmodel = ReIDModel(CLIPConfig(**dataclasses.asdict(clip)), NC, camera_num=14, view_num=1)
    tmodel.load_state_dict(from_jax_variables(variables, tmodel.clip_config), strict=True)
    return tmodel.eval()


@pytest.mark.parametrize("shared_routing", [True, False])
@pytest.mark.parametrize("moe_layers", [1, 2, -1])
def test_moe_tower_matches_jax(moe_layers, shared_routing):
    """(x11, x12, xproj, router_logits) of the eval forward, and the train
    forward's features and router logits: only block 0 gates under shared
    routing, every MoE block without it; x11 is the last block's output."""
    clip, jmodel, variables = _jax_reid(moe_layers, shared_routing)
    tmodel = _port_reid(clip, variables)
    x = _normalized(_images(4), _cfg()[0])
    want = jmodel.apply(variables, jnp.asarray(x), method=lambda m, x: m.image_encoder(x, None))
    with torch.no_grad():
        got = tmodel.image_encoder(_t(x))
    n_moe = 2 if moe_layers == -1 else moe_layers
    n_gating = 1 if shared_routing else n_moe
    assert tuple(got[3].shape) == (n_gating, 4 * 3, E) == want[3].shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=0)
    with torch.no_grad():  # x11 is the last block's output: x12 is ln_post of it
        torch.testing.assert_close(tmodel.image_encoder.ln_post(got[0]), got[1])
    jout, _ = jmodel.apply(variables, jnp.asarray(x), jnp.zeros(4, jnp.int32), train=True,
                           mutable=["batch_stats"])
    with torch.no_grad():
        tout = tmodel.forward_train(_t(x), torch.zeros(4, dtype=torch.long))
    np.testing.assert_allclose(_np(tout["router_logits"]), _np(jout["router_logits"]),
                               atol=1e-5, rtol=0)
    for g, w in zip(tout["feats"], jout["feats"]):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("uniprompt", [False, True])
def test_from_jax_variables_on_an_moe_tree_equals_export(uniprompt, tmp_path):
    """The reference layout, key for key (``gate.weight``,
    ``experts.{m}.c_{fc,proj}.*``), and ``load_param`` reads it strictly."""
    if uniprompt:
        clip, jmodel, variables = _jax_uni("distinct")
    else:
        clip, jmodel, variables = _jax_reid(2, True)
    want = export_reid_state_dict(variables, jmodel)
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    got = from_jax_variables(variables, tclip)
    extra = {"text_encoder.token_embedding.weight"} if uniprompt else set()
    assert set(got) == set(want) | extra
    assert "image_encoder.transformer.resblocks.1.experts.3.c_proj.bias" in want
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0, msg=k)
    path = str(tmp_path / "moe.pth")
    torch.save(want, path)
    cls = UniPromptReID if uniprompt else ReIDModel
    tmodel = load_param(path, cls(tclip, NC, camera_num=14, view_num=1))
    sd = tmodel.state_dict()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], atol=0, rtol=0, msg=k)
    with pytest.raises(RuntimeError, match="experts"):
        bad = {k: v for k, v in want.items() if ".experts.2." not in k}
        torch.save(bad, path)
        load_param(path, cls(tclip, NC, camera_num=14, view_num=1))


# ---------------------------------------------------------------------------
# upcycling and the Uni-Prompt steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_uni(kind):
    """(JAX clip config, JAX Uni-Prompt model, perturbed variables): "dense",
    "upcycled" (the dense tree through the JAX package's switch_to_moe: zero
    gates, every expert its block's MLP) or "distinct" (an MoE init: random
    experts and gates)."""
    jcfg = _cfg(**MOE)[0]
    dense = tiny_clip_config()
    if kind == "distinct":
        clip = tiny_clip_config(num_experts=E, top_k=TOP_K, moe_layers=2)
        jmodel = JaxUniPromptReID(clip_config=clip, num_classes=NC, camera_num=14, view_num=1)
        return clip, jmodel, _seeded(init_variables(jmodel, jax.random.PRNGKey(0), jcfg,
                                                    abstract=True), 1)
    jmodel = JaxUniPromptReID(clip_config=dense, num_classes=NC, camera_num=14, view_num=1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), jcfg, abstract=True))
    if kind == "dense":
        return dense, jmodel, variables
    jmodel, up = jax_switch_to_moe(jcfg, jmodel, variables)
    up = {"params": jax.tree_util.tree_map(np.asarray, dict(up["params"])),
          "batch_stats": variables["batch_stats"]}
    return jmodel.clip_config, jmodel, up


def _port_uni(kind):
    clip, jmodel, variables = _jax_uni(kind)
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    tmodel = UniPromptReID(tclip, NC, camera_num=14, view_num=1)
    tmodel.load_state_dict(from_jax_variables(variables, tclip), strict=True)
    return jmodel, variables, tmodel.eval()


def test_switch_to_moe_grafts_and_equals_jax():
    """The port's upcycled model equals the JAX package's upcycled tree
    carried across, leaf for leaf: experts copied from the dense MLPs, gates
    zero, the rest (BN statistics included) as it was."""
    _, tcfg = _cfg(**MOE)
    _, _, dense = _port_uni("dense")
    moe = switch_to_moe(tcfg, dense)
    assert moe is not dense and moe.clip_config.use_moe and not dense.clip_config.use_moe
    _, _, want = _port_uni("upcycled")
    got_sd, want_sd = moe.state_dict(), want.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        torch.testing.assert_close(got_sd[k], v, atol=0, rtol=0, msg=k)
    block = "image_encoder.transformer.resblocks.1"
    assert not got_sd[f"{block}.gate.weight"].any()
    for m in range(E):
        torch.testing.assert_close(got_sd[f"{block}.experts.{m}.c_fc.weight"],
                                   dense.state_dict()[f"{block}.mlp.c_fc.weight"], atol=0, rtol=0)


def test_switch_to_moe_keeps_adapters_and_statistics():
    _, tcfg = _cfg(**MOE, **{"SOLVER.LORA.ENABLED": True, "SOLVER.LORA.LORA_R": 4})
    clip = CLIPConfig(**dataclasses.asdict(tiny_clip_config(lora_rank=4)))
    dense = UniPromptReID(clip, NC, camera_num=14, view_num=1)
    dense.init_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _, buf in dense.named_buffers():
            if buf.is_floating_point():
                buf.uniform_(0.5, 1.5)
        for name, p in dense.named_parameters():
            if "lora_b" in name:
                p.normal_()
    moe = switch_to_moe(tcfg, dense)
    sd = moe.state_dict()
    for k, v in dense.state_dict().items():
        if ".mlp." not in k:
            torch.testing.assert_close(sd[k], v, atol=0, rtol=0, msg=k)
    assert any("lora_a" in k for k in sd) and moe.clip_config.lora_rank == 4


def test_switch_to_moe_is_idempotent_and_a_no_op_when_disabled():
    _, tcfg = _cfg(**MOE)
    _, off = _cfg()
    _, _, dense = _port_uni("dense")
    assert switch_to_moe(off, dense) is dense
    moe = switch_to_moe(tcfg, dense)
    assert switch_to_moe(tcfg, moe) is moe


def test_upcycled_model_equals_the_dense_one_at_step_0():
    """Every expert of a block is its MLP and the routing ties, so each
    token mixes two copies of one MLP at ½ each: eval features fp32 to 1e-5,
    and the upcycled train forward's router logits are all zero."""
    _, tcfg = _cfg(**MOE)
    _, _, dense = _port_uni("dense")
    moe = switch_to_moe(tcfg, dense)
    x = _t(_normalized(_images(4), tcfg))
    with torch.no_grad():
        f_dense, f_moe = dense(x), moe(x)
        logits = moe.forward_train(x, torch.zeros(4, dtype=torch.long))["router_logits"]
    np.testing.assert_allclose(_np(f_moe), _np(f_dense), atol=1e-5, rtol=0)
    assert not logits.any() and tuple(logits.shape) == (1, 4 * 3, E)


@pytest.mark.parametrize("stage", ["stage2a", "stage2b"])
def test_stage_trainable_matches_jax_for_every_leaf_of_an_moe_tree(stage):
    """Stage 2b trains the gates and the image encoder less its experts;
    stage 2a everything but the text tower, the experts and the prompts (so
    the gates train in both)."""
    clip, _, variables = _jax_uni("distinct")
    _, _, tmodel = _port_uni("distinct")
    jtrain = joptim.stage_trainable(variables["params"], stage)
    ttrain = stage_trainable(tmodel, stage)
    filled = jax.tree_util.tree_map(lambda x, v: np.full(np.shape(x), float(v), np.float32),
                                    variables["params"], jtrain)
    carried = UniPromptReID(tmodel.clip_config, NC, camera_num=14, view_num=1)
    carried.load_state_dict(
        from_jax_variables({"params": filled, "batch_stats": variables["batch_stats"]},
                           tmodel.clip_config), strict=True)
    for name, param in carried.named_parameters():
        assert np.unique(_np(param)).tolist() == [float(ttrain[name])], name
    gates = [n for n in ttrain if n.endswith("gate.weight")]
    experts = [n for n in ttrain if ".experts." in n]
    assert len(gates) == 2 and len(experts) == 8
    assert all(ttrain[n] for n in gates)
    assert not any(ttrain[n] for n in experts)


def _assert_grads_close(got, want):
    floor = 1e-3 * max(float(np.linalg.norm(_np(want[n]))) for n in got)
    for name, g in got.items():
        diff = float(np.linalg.norm(_np(g) - _np(want[name])))
        assert diff <= 1e-4 * max(float(np.linalg.norm(_np(want[name]))), floor), name


def _assert_params_close(tmodel, ref, lr, mult):
    """Parameters after an Adam step to 0.25·lr·mult; an element whose
    gradient is within rounding of zero may step the other way (one element
    in 10⁴ of a leaf, and one in any leaf, up to 2·lr·mult)."""
    for name, param in tmodel.named_parameters():
        unit = lr * mult.get(name, 1.0)
        err = np.abs(_np(param) - _np(ref[name]))
        assert (err > 0.25 * unit).sum() <= max(1, err.size // 10_000), (name, float(err.max()))
        assert float(err.max()) <= 2 * unit, (name, float(err.max()), unit)


@pytest.mark.parametrize("stage", ["stage2a", "stage2b"])
@pytest.mark.parametrize("kind", ["upcycled", "distinct"])
def test_stage2_moe_step_matches_jax(kind, stage):
    """One stage-2 step of the MoE model, augmentation off: the loss with
    the load-balancing term, its gradients over the stage's trainable leaves
    (the gates included; on the upcycled tree every token ties), then the
    step through both packages' make_train_step: loss, acc and every
    parameter after it. Under shared routing block 1's gate is unused: a
    zero gradient, and in stage 2b the coupled L2 moves it as in JAX."""
    jcfg, tcfg = _cfg(**MOE)
    jmodel, variables, tmodel = _port_uni(kind)
    batch = {"images": _images(8, seed=3), "pids": np.repeat(np.arange(2), 4).astype(np.int32),
             "camids": np.zeros(8, np.int32), "trackids": np.zeros(8, np.int32)}
    lr = 1e-3
    text = juni.precompute_text_features(jcfg, jmodel, variables, NC)
    x = jnp.asarray(_normalized(batch["images"], jcfg))
    target = jnp.asarray(batch["pids"])
    jloss_fn, _ = jax_make_loss(jcfg, NC)
    coeff = jcfg.MODEL.MOE.AUX_LOSS_COEFF

    def inner(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x, target, train=True, mutable=["batch_stats"])
        logits = jnp.dot(out["img_feature_proj"].astype(jnp.float32),
                         jnp.asarray(text, jnp.float32).T)
        loss = jloss_fn(out["scores"][0], out["feats"][1], target, None, logits)
        aux = jnp.mean(jax.vmap(lambda l: jmoe.load_balancing_loss(l, TOP_K))(
            out["router_logits"]))
        return loss + coeff * aux, mut

    (jloss, jmut), jg = jax.value_and_grad(inner, has_aux=True)(variables["params"])
    ref_g = from_jax_variables({"params": jg, "batch_stats": jmut["batch_stats"]},
                               tmodel.clip_config)
    stacked = UniPromptReID(tmodel.clip_config, NC, camera_num=14, view_num=1)
    stacked.load_state_dict(ref_g, strict=True)
    ref_named = dict(stacked.named_parameters())

    loss_fn, _ = make_loss(tcfg, NC)
    opt = make_optimizer(tcfg.SOLVER.STAGE2, tmodel, stage=stage)
    text_t = precompute_text_features(tcfg, tmodel, NC)
    loss, acc, grads, _ = loss_and_grads(tmodel, tcfg, loss_fn, opt, _t(np.asarray(x)),
                                         _t(batch["pids"]).long(), text_features=text_t)
    assert abs(float(loss) - float(jloss)) <= 1e-4 * abs(float(jloss))
    assert set(grads) == {n for n, f in opt.trainable.items() if f}
    _assert_grads_close(grads, ref_named)
    gate0 = "image_encoder.transformer.resblocks.0.gate.weight"
    gate1 = "image_encoder.transformer.resblocks.1.gate.weight"
    assert float(grads[gate0].abs().max()) > 0 and not grads[gate1].any()
    assert not any(".experts." in n or n.startswith("text_encoder.") for n in grads)

    # the step itself, through both packages' make_train_step
    tmodel.load_state_dict(from_jax_variables(variables, tmodel.clip_config), strict=True)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    state = initial_state(tmodel, opt)
    step = make_train_step(tmodel, tcfg, loss_fn, opt, uniprompt=True, text_features=text_t)
    state, metrics = step(state, batch, lr, torch.Generator().manual_seed(0))
    jopt = jax_make_optimizer(jcfg.SOLVER.STAGE2, variables["params"], stage=stage)
    jstate = jax_initial_state(variables, jopt)
    jstep = jsteps.make_train_step(jmodel, jcfg, jloss_fn, jopt, uniprompt=True,
                                   text_features=jnp.asarray(text))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, lr,
                       jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-4 * abs(float(jloss))
    assert float(metrics["acc"]) == float(jm["acc"])
    after = UniPromptReID(tmodel.clip_config, NC, camera_num=14, view_num=1)
    after.load_state_dict(from_jax_variables({"params": jstate.params,
                                              "batch_stats": jstate.batch_stats},
                                             tmodel.clip_config), strict=True)
    _assert_params_close(tmodel, dict(after.named_parameters()), lr, opt.lr_mult)
    for name, p in tmodel.named_parameters():
        if not opt.trainable[name]:
            torch.testing.assert_close(p.detach(), before[name], atol=0, rtol=0, msg=name)
