"""``TPU.REMAT`` in the port: rematerialised vision blocks against plain ones and against the JAX package.

The JAX package wraps every ViT block, dense and MoE, in ``nn.remat``
(mpreid_tpu/models/vit.py:150-152); the port runs each block under
``torch.utils.checkpoint`` while gradients are on
(``models/vit.py::rematerialised``). Results must not change, so with
``TPU.REMAT`` on the port's train step must equal its step with it off
bit for bit (``torch.equal``): the loss, every gradient, the parameters
after the step and, with the MoE experts' dropout at 0.1, the step
generator's state after it (the recompute draws the forward's mask from a
copy of the generator, so the step's own advances once). Cases: the dense
baseline, the MoE tower with dropout, Uni-Prompt stage 2a, fp32 and bf16;
the device-resident epoch; RN50 and the text tower, which never
rematerialise. Each vision block runs its forward twice a step under
remat (the recompute) and once without it.

Two gloo ranks (``parallel.launch.spawn``, one job for the module): data
parallel with MoE dropout (the recompute re-enters the forward's
``global_batch`` mesh, so it draws the global batch's mask) and tensor-
parallel towers on a 1 × 2 mesh (the recompute repeats the blocks'
all-reduces inside the backward), each bit for bit against remat off.

Against the JAX package, dropout 0 (a JAX run with dropout above 0 cannot
start): the dense tower with ``remat=True`` on both sides; the MoE tower
with remat on in the port against the JAX package's MoE step without it,
because the JAX package's rematerialised MoE block does not start
(``nn.remat(MoEResidualAttentionBlock, static_argnums=(4,))`` names an
argument index its call does not have: ``ValueError`` from
``jax.checkpoint``, pinned below), and remat changes no result. Both at
tests/test_torch_train.py's tolerances: the loss to 1e-5 relative,
gradients per leaf to a norm-relative 1e-4 (the reference norm floored at
1e-3 of the largest leaf's), BN running statistics to 1e-6, parameters
after an Adam step to 0.25·lr·mult (the MoE tower's as
tests/test_torch_moe.py holds them: its tied routing lets an element whose
gradient is within rounding of zero step the other way).

This module imports nothing of JAX at its top: the spawned ranks import it
to find their function.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    initial_state, loss_and_grads, make_stage1_step, make_train_epoch, make_train_step,
    precompute_text_features,
)
from mpreid_tpu_torch.engine.steps import augment_args
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import (
    RN50, VIT_B16, ModifiedResNet, ReIDModel, UniPromptReID, build_model,
    build_model_uniprompt, switch_to_moe,
)
from mpreid_tpu_torch.models.layers import MarginHead
from mpreid_tpu_torch.ops.augment import train_augment
from mpreid_tpu_torch.parallel import make_mesh, shard_batch, shard_module
from mpreid_tpu_torch.parallel.launch import spawn
from mpreid_tpu_torch.solver import make_optimizer

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

NC, BATCH, E, TOP_K = 8, 8, 4, 2
LR, SEED = 1e-3, 5
TINY = dict(embed_dim=32, vision_layers=2, vision_width=64, transformer_width=64,
            transformer_heads=1, transformer_layers=2, h_resolution=2, w_resolution=1)
MOE = dict(num_experts=E, top_k=TOP_K, moe_layers=2, dropout=0.1)
RN50_TINY = dataclasses.replace(RN50, vision_layers=(1, 1, 1, 1), vision_width=8, embed_dim=32,
                                transformer_width=64, transformer_heads=1, transformer_layers=2,
                                h_resolution=4, w_resolution=2)
KINDS = {  # name: (stage, clip config, model class)
    "dense": ("baseline", dataclasses.replace(VIT_B16, **TINY), ReIDModel),
    "moe": ("baseline", dataclasses.replace(VIT_B16, **TINY, **MOE), ReIDModel),
    "stage2a": ("stage2a", dataclasses.replace(VIT_B16, **TINY), UniPromptReID),
    "rn50": ("baseline", RN50_TINY, ReIDModel),
}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _cfg(kind, batch=BATCH, dtype="fp32", **overrides):
    """The port's config of ``kind``, augmentation on (the step draws it)."""
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE = "cpu"
    cfg.MODEL.NAME = "RN50" if kind == "rn50" else "ViT-B-16"
    hw = [64, 32] if kind == "rn50" else [32, 16]
    cfg.INPUT.SIZE_TRAIN = cfg.INPUT.SIZE_TEST = hw
    cfg.INPUT.PADDING = 4
    cfg.TPU.COMPUTE_DTYPE = {"fp32": "float32", "bf16": "bfloat16"}[dtype]
    cfg.SOLVER.IMS_PER_BATCH = cfg.SOLVER.STAGE2.IMS_PER_BATCH = batch
    if kind == "moe":
        cfg.MODEL.MOE.ENABLED = True
        cfg.MODEL.MOE.NUM_EXPERTS, cfg.MODEL.MOE.TOP_K = E, TOP_K
        cfg.MODEL.MOE.MOE_LAYERS, cfg.MODEL.MOE.DROPOUT = 2, 0.1
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = node[part]
        node[leaf] = value
    return cfg


def _model(kind, remat, dtype="fp32", clip=None):
    _, default_clip, cls = KINDS[kind]
    model = cls(clip or default_clip, NC, camera_num=14, view_num=1, dtype=DTYPES[dtype],
                remat=remat)
    model.init_(torch.Generator().manual_seed(0))
    return model


def _batch(kind, n=BATCH, seed=3):
    rng = np.random.default_rng(seed)
    hw = (64, 32) if kind == "rn50" else (32, 16)
    return {"images": rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8),
            "pids": np.repeat(np.arange(n // 4), 4).astype(np.int32),
            "camids": rng.integers(0, 6, n).astype(np.int32),
            "trackids": np.zeros(n, np.int32)}


def _stage_cfg(cfg, stage):
    return cfg.SOLVER if stage == "baseline" else cfg.SOLVER.STAGE2


def _count_forwards(modules) -> list:
    """One counter per module, bumped as each of its forwards starts (the
    recompute stops once it has rebuilt what the backward needs, so a block's
    forward may not return)."""
    counts = [0] * len(modules)
    for i, m in enumerate(modules):
        def hook(*_, i=i):
            counts[i] += 1
        m.register_forward_pre_hook(hook)
    return counts


def _blocks(model):
    tower = model.image_encoder
    return [] if isinstance(tower, ModifiedResNet) else list(tower.transformer.resblocks)


def _run(kind, remat, dtype="fp32", mesh=None, clip=None, tp_towers=False):
    """The gradients of one forward (augmentation on, the step's generator
    drawing it and the experts' dropout), then one step through
    ``make_train_step`` with the same generator: every result, the
    generator's state after each, and each vision block's forward count in
    the first."""
    stage = KINDS[kind][0]
    cfg = _cfg(kind, dtype=dtype)
    model = _model(kind, remat, dtype, clip)
    text = precompute_text_features(cfg, model, NC) if stage != "baseline" else None
    if mesh is not None and mesh.model > 1:
        shard_module(model, mesh, tp_towers)
    dp = mesh is not None and mesh.data > 1
    batch = shard_batch(_batch(kind), mesh) if dp else _batch(kind)
    opt = make_optimizer(_stage_cfg(cfg, stage), model, stage=stage)
    loss_fn = make_loss(cfg, NC)[0]
    gen = torch.Generator().manual_seed(SEED)
    counts = _count_forwards(_blocks(model))
    x = train_augment(torch.from_numpy(batch["images"]), gen, **augment_args(cfg),
                      shard=(mesh.data, mesh.rank) if dp else None)
    loss, acc, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x,
                                         torch.from_numpy(batch["pids"]).long(),
                                         text_features=text, gen=gen, mesh=mesh)
    out = {"loss": loss, "acc": acc, "grads": grads, "gen": gen.get_state(),
           "forwards": list(counts)}
    state = initial_state(model, opt)
    step = make_train_step(model, cfg, loss_fn, opt, uniprompt=text is not None,
                           text_features=text, mesh=mesh)
    state, metrics = step(state, batch, LR, gen)
    out.update(step_loss=metrics["loss"], step_gen=gen.get_state(),
               params={k: p.detach().clone() for k, p in model.named_parameters()},
               buffers={k: b.clone() for k, b in model.named_buffers()})
    return out


def _assert_bitwise(got, want):
    """Every tensor of ``got`` equal to ``want``'s, bit for bit."""
    for key in ("loss", "acc", "gen", "step_loss", "step_gen"):
        assert torch.equal(got[key], want[key]), key
    for key in ("grads", "params", "buffers"):
        assert set(got[key]) == set(want[key]), key
        for name, t in want[key].items():
            diff = (got[key][name].float() - t.float()).abs().max().item()
            assert torch.equal(got[key][name], t), (key, name, diff)


# ---------------------------------------------------------------------------
# one process: remat on equals remat off
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,dtype", [("dense", "fp32"), ("dense", "bf16"), ("moe", "fp32"),
                                        ("moe", "bf16"), ("stage2a", "fp32"), ("rn50", "fp32")])
def test_remat_step_equals_the_plain_step_bit_for_bit(kind, dtype):
    off, on = _run(kind, False, dtype), _run(kind, True, dtype)
    _assert_bitwise(on, off)
    n_blocks = len(off["forwards"])
    assert off["forwards"] == [1] * n_blocks
    # the recompute runs each vision block's forward a second time; RN50 has none
    assert on["forwards"] == [2] * n_blocks
    assert (n_blocks == 0) == (kind == "rn50")


def test_remat_moe_dropout_draws_and_advances_the_generator_as_without_it():
    """Dropout 0.1 draws a mask: a different generator seed changes the
    loss, so the bit-for-bit equality above is the mask's; and the step
    generator ends where the plain forward leaves it."""
    cfg = _cfg("moe")
    results = {}
    for remat in (False, True):
        model = _model("moe", remat)
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        x = train_augment(torch.from_numpy(_batch("moe")["images"]),
                          torch.Generator().manual_seed(SEED), **augment_args(cfg))
        target = torch.from_numpy(_batch("moe")["pids"]).long()
        for seed in (1, 2):
            gen = torch.Generator().manual_seed(seed)
            loss, *_ = loss_and_grads(model, cfg, make_loss(cfg, NC)[0], opt, x, target,
                                      gen=gen)
            results[remat, seed] = (loss, gen.get_state())
    for seed in (1, 2):
        assert torch.equal(results[True, seed][0], results[False, seed][0])
        assert torch.equal(results[True, seed][1], results[False, seed][1])
    assert not torch.equal(results[False, 1][0], results[False, 2][0])


def test_remat_device_epoch_equals_the_plain_epoch_bit_for_bit():
    """``make_train_epoch`` (``TPU.DEVICE_DATASET``) shares the step's body:
    two batches of the MoE tower with dropout, remat on against off."""
    cfg = _cfg("moe")
    batch = _batch("moe", n=2 * BATCH, seed=9)
    data = [torch.from_numpy(batch[k]) for k in ("images", "pids", "camids", "trackids")]
    perm = torch.arange(2 * BATCH).reshape(2, BATCH)
    out = {}
    for remat in (False, True):
        model = _model("moe", remat)
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        state = initial_state(model, opt)
        gen = torch.Generator().manual_seed(SEED)
        epoch = make_train_epoch(model, cfg, make_loss(cfg, NC)[0], opt)
        state, (losses, accs) = epoch(state, *data, perm, LR, gen)
        out[remat] = (losses, accs, gen.get_state(),
                      {k: p.detach().clone() for k, p in model.named_parameters()})
    for a, b in zip(out[True][:3], out[False][:3]):
        assert torch.equal(a, b)
    for name, p in out[False][3].items():
        assert torch.equal(out[True][3][name], p), name


def test_remat_leaves_the_text_tower_as_it_is():
    """A stage-1 step trains the prompts through the text tower: equal bit
    for bit with remat on, and each text block runs once a step."""
    cfg = _cfg("stage2a")
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 32))
                             .astype(np.float32))
    target = torch.from_numpy(_batch("stage2a")["pids"]).long()
    out = {}
    for remat in (False, True):
        model = _model("stage2a", remat)
        counts = _count_forwards(list(model.text_encoder.transformer.resblocks))
        opt = make_optimizer(cfg.SOLVER.STAGE1A, model, stage="stage1a")
        state = initial_state(model, opt)
        state, metrics = make_stage1_step(model, cfg, opt, "1a")(state, feats, target, None, LR)
        out[remat] = (metrics["loss"], counts,
                      {k: p.detach().clone() for k, p in model.named_parameters()})
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1] == [1, 1]
    for name, p in out[False][2].items():
        assert torch.equal(out[True][2][name], p), name


def test_remat_runs_the_blocks_plainly_without_gradients():
    """Eval (and the stage-1 bank) runs under ``no_grad``: no checkpoint, so
    each block runs once and the features are the plain model's."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 32, 16, 3))
                         .astype(np.float32))
    feats = {}
    for remat in (False, True):
        model = _model("moe", remat).eval()
        counts = _count_forwards(_blocks(model))
        with torch.no_grad():
            feats[remat] = model(x)
        assert counts == [1, 1]
    assert torch.equal(feats[True], feats[False])


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ViT-B-16", "RN50"])
@pytest.mark.parametrize("uniprompt", [False, True])
def test_the_factory_reads_tpu_remat(name, uniprompt):
    """``TPU.REMAT`` reaches the ViT, and not the RN50 tower (the JAX
    package builds RN50 without it, ref clip_model.py:132)."""
    build = build_model_uniprompt if uniprompt else build_model
    for remat in (False, True):
        cfg = _cfg("rn50" if name == "RN50" else "dense", **{"TPU.REMAT": remat})
        cfg.MODEL.NAME = name
        with torch.device("meta"):
            model = build(cfg, NC, 14, 1)
        assert model.remat is remat
        tower = model.image_encoder
        if name == "RN50":
            assert isinstance(tower, ModifiedResNet) and not hasattr(tower, "remat")
        else:
            assert tower.remat is remat


@pytest.mark.parametrize("remat", [False, True])
def test_switch_to_moe_keeps_remat_and_the_margin_head(remat):
    """The upcycled model is the dense one with ``MODEL.MOE``'s experts, as
    the JAX package's ``dataclasses.replace(model, clip_config=...)`` keeps
    every other field: ``remat`` and the margin head (``MODEL.COS_LAYER``),
    which the rebuild once dropped for a plain classifier."""
    cfg = _cfg("stage2a", **{"TPU.REMAT": remat, "MODEL.COS_LAYER": True,
                             "MODEL.COS_LAYER_TYPE": "arcface", "MODEL.MOE.ENABLED": True,
                             "MODEL.MOE.NUM_EXPERTS": E, "MODEL.MOE.TOP_K": TOP_K,
                             "MODEL.MOE.MOE_LAYERS": 2})
    dense = UniPromptReID(KINDS["stage2a"][1], NC, camera_num=14, view_num=1,
                          cos_layer="arcface", remat=remat)
    dense.init_(torch.Generator().manual_seed(0))
    moe = switch_to_moe(cfg, dense)
    assert moe.clip_config.use_moe and moe.remat is remat and moe.image_encoder.remat is remat
    for head in ("classifier", "classifier_proj"):
        assert isinstance(getattr(moe, head), MarginHead), head
        assert getattr(moe, head).kind == getattr(dense, head).kind
        torch.testing.assert_close(getattr(moe, head).weight, getattr(dense, head).weight,
                                   atol=0, rtol=0)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

TP_CLIP = dataclasses.replace(VIT_B16, **dict(TINY, vision_width=128, transformer_width=128,
                                              transformer_heads=2))


def _remat_job():
    dp = make_mesh()
    out = {"dp": {remat: _run("moe", remat, mesh=dp) for remat in (False, True)}}
    tp = make_mesh(data=1, model=2)
    out["tp"] = {remat: _run("dense", remat, mesh=tp, clip=TP_CLIP, tp_towers=True)
                 for remat in (False, True)}
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_remat_job, 2, (), timeout=300, threads=2)


@pytest.mark.parametrize("case", ["dp", "tp"])
def test_remat_equals_the_plain_step_on_two_ranks(ranks, case):
    """Data parallel with MoE dropout (each rank its rows of the global
    batch's mask, drawn again in the recompute) and tensor-parallel towers
    on a 1 × 2 mesh (the blocks' all-reduces repeated in the backward): on
    each rank remat on equals off bit for bit, and the ranks agree on the
    loss."""
    for rank in ranks:
        off, on = rank[case][False], rank[case][True]
        _assert_bitwise(on, off)
        assert on["forwards"] == [2, 2] and off["forwards"] == [1, 1]
    assert torch.equal(ranks[0][case][True]["loss"], ranks[1][case][True]["loss"])


# ---------------------------------------------------------------------------
# against the JAX package, remat on both sides
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_case(kind, remat=True):
    """(JAX config, JAX model, seeded variables, port config, port CLIP
    config, port state dict carrying the variables), MoE dropout 0."""
    import jax

    from mpreid_tpu.models.factory import init_variables
    from mpreid_tpu.models.reid import ReIDModel as JaxReIDModel
    from mpreid_tpu_torch.models import CLIPConfig, from_jax_variables
    from test_torch_moe import _seeded
    from tiny import tiny_cfg, tiny_clip_config

    moe = kind == "moe"
    overrides = {"INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                 "TPU.REMAT": remat}
    if moe:
        overrides.update({"MODEL.MOE.ENABLED": True, "MODEL.MOE.NUM_EXPERTS": E,
                          "MODEL.MOE.TOP_K": TOP_K, "MODEL.MOE.MOE_LAYERS": 2})
    jcfg = tiny_cfg(**overrides)
    clip = tiny_clip_config(**({"num_experts": E, "top_k": TOP_K, "moe_layers": 2} if moe
                               else {}))
    jmodel = JaxReIDModel(clip_config=clip, num_classes=NC, camera_num=14, view_num=1,
                          remat=remat)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), jcfg, abstract=True), 1)
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    tcfg = get_default_cfg()
    tcfg.merge_from_other_cfg(jcfg)
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, jmodel, variables, tcfg, tclip, from_jax_variables(variables, tclip)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def test_the_jax_moe_tower_does_not_start_under_remat():
    """The reason the MoE case below holds the port to the JAX package's
    step without remat."""
    with pytest.raises(ValueError, match="static_argnums"):
        _jax_case("moe", remat=True)  # its init already applies the tower


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_remat_step_matches_the_jax_remat_step(kind):
    """One forward and its gradients (augmentation off) and one step through
    both packages' ``make_train_step``, ``TPU.REMAT`` on in the port; in
    the JAX package on for the dense tower, off for the MoE one."""
    import jax
    import jax.numpy as jnp

    from mpreid_tpu.engine.steps import make_train_step as jax_make_train_step
    from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
    from mpreid_tpu.losses import make_loss as jax_make_loss
    from mpreid_tpu.models import moe as jmoe
    from mpreid_tpu.ops import augment as jaug
    from mpreid_tpu.solver import optim as joptim
    from mpreid_tpu_torch.models import from_jax_variables

    jcfg, jmodel, variables, tcfg, clip, sd = _jax_case(kind, remat=kind == "dense")
    tcfg = tcfg.clone()
    tcfg.TPU.REMAT = True
    batch = _batch(kind)
    x = jaug.eval_preprocess(jnp.asarray(batch["images"]), mean=tuple(jcfg.INPUT.PIXEL_MEAN),
                             std=tuple(jcfg.INPUT.PIXEL_STD))
    target = jnp.asarray(batch["pids"])
    jloss_fn, _ = jax_make_loss(jcfg, NC)
    coeff = jcfg.MODEL.MOE.AUX_LOSS_COEFF

    def inner(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                x, target, train=True, mutable=["batch_stats"])
        loss = jloss_fn(out["scores"], out["feats"], target, None)
        if kind == "moe":
            loss = loss + coeff * jnp.mean(jax.vmap(
                lambda l: jmoe.load_balancing_loss(l, TOP_K))(out["router_logits"]))
        return loss, mut

    (jloss, jmut), jg = jax.value_and_grad(inner, has_aux=True)(variables["params"])
    carried = ReIDModel(clip, NC, camera_num=14, view_num=1)  # MoE leaves stacked as the port's
    carried.load_state_dict(from_jax_variables({"params": jg, "batch_stats": jmut["batch_stats"]},
                                               clip), strict=True)
    ref = {**dict(carried.named_parameters()), **dict(carried.named_buffers())}

    model = ReIDModel(clip, NC, camera_num=14, view_num=1, remat=True)
    model.load_state_dict(sd, strict=True)
    counts = _count_forwards(_blocks(model))
    loss_fn = make_loss(tcfg, NC)[0]
    opt = make_optimizer(tcfg.SOLVER, model, stage="baseline")
    loss, _, grads, _ = loss_and_grads(model, tcfg, loss_fn, opt, torch.from_numpy(np.array(x)),
                                       torch.from_numpy(batch["pids"]).long())
    assert counts == [2, 2]
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    floor = 1e-3 * max(float(np.linalg.norm(_np(ref[n]))) for n in grads)
    for name, g in grads.items():
        diff = float(np.linalg.norm(_np(g) - _np(ref[name])))
        assert diff <= 1e-4 * max(float(np.linalg.norm(_np(ref[name]))), floor), (name, diff)
    sd_now = model.state_dict()
    for name in ("bottleneck", "bottleneck_proj"):
        for stat in ("running_mean", "running_var"):
            np.testing.assert_allclose(_np(sd_now[f"{name}.{stat}"]),
                                       _np(ref[f"{name}.{stat}"]), atol=1e-6, rtol=0)

    # the step itself, through both packages' make_train_step
    model.load_state_dict(sd, strict=True)
    opt = make_optimizer(tcfg.SOLVER, model, stage="baseline")
    state = initial_state(model, opt)
    state, metrics = make_train_step(model, tcfg, loss_fn, opt)(
        state, batch, LR, torch.Generator().manual_seed(0))
    jopt = joptim.make_optimizer(jcfg.SOLVER, variables["params"], stage="baseline")
    jstate = jax_initial_state(variables, jopt)
    jstep = jax_make_train_step(jmodel, jcfg, jloss_fn, jopt)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, LR,
                       jax.random.PRNGKey(0))
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jloss))
    assert float(metrics["acc"]) == float(jm["acc"])
    carried.load_state_dict(from_jax_variables({"params": jstate.params,
                                                "batch_stats": jstate.batch_stats}, clip))
    ref_p = dict(carried.named_parameters())
    if kind == "moe":  # the gates tie: tests/test_torch_moe.py's rule
        from test_torch_moe import _assert_params_close

        _assert_params_close(model, ref_p, LR, opt.lr_mult)
        return
    for name, p in model.named_parameters():
        unit = LR * opt.lr_mult.get(name, 1.0)
        assert float(np.abs(_np(p) - _np(ref_p[name])).max()) <= 0.25 * unit, name
