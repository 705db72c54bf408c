"""The port's data-parallel train step against its single-process step and the JAX package's.

Two gloo ranks on the CPU (one job for the module, ``parallel.launch.spawn``)
each take their block of a global batch of 16 and run the data-parallel
``loss_and_grads`` and ``make_train_step`` (``engine/steps.py``). Every
result must be the single-process one on the global batch, as GSPMD's is in
the JAX package (tests/test_dp_equivalence.py, tests/test_multiprocess.py):

* against the port's single-process step, augmentation on (each rank takes
  its rows of the global batch's draws): fp32 loss to 1e-5 relative, every
  gradient to 1e-5 norm-relative (the reference norm floored at 1e-3 of the
  largest leaf's: a leaf whose exact gradient is zero carries only rounding
  noise), the center-loss centers' gradient (downstream of the gather, not
  summed) and the BatchNorms' running statistics (global-batch statistics)
  to 1e-5, the accuracy equal; the parameters after one SGD step to 1e-5;
* against the JAX package's step over ``make_mesh(data=8)`` from the same
  weights, augmentation off: loss rtol 1e-4, parameters after SGD rtol
  1e-4 and atol 1e-6 (test_dp_equivalence.py's bounds);
* both ranks end with the same parameters, bit for bit.

Cases: the baseline (tiny ViT, triplet + BNNeck + center loss), Uni-Prompt
stage 2a (the i2t term), MoE stage 2b (4 experts, top-2, the aux loss) and
RN50 (its BatchNorm2d running statistics; against the port only: the JAX
package's RN50 init is the slow part of tests/test_torch_resnet.py).

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
    initial_state, loss_and_grads, make_train_step, precompute_text_features,
)
from mpreid_tpu_torch.engine.steps import augment_args
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import RN50, ReIDModel, UniPromptReID
from mpreid_tpu_torch.ops.augment import train_augment
from mpreid_tpu_torch.parallel import make_mesh, shard_batch
from mpreid_tpu_torch.parallel.launch import spawn
from mpreid_tpu_torch.solver import make_optimizer

WORLD, BATCH, NC = 2, 16, 8
LR, SEED = 1e-3, 5
E, TOP_K = 4, 2
TOL = 1e-5
RN50_TINY = dataclasses.replace(RN50, vision_layers=(1, 1, 1, 1), vision_width=8, embed_dim=32,
                                transformer_width=64, transformer_heads=1, transformer_layers=2,
                                h_resolution=4, w_resolution=2)
CASES = ("baseline", "stage2a", "moe2b", "rn50")
STAGE = {"baseline": "baseline", "stage2a": "stage2a", "moe2b": "stage2b", "rn50": "baseline"}


def _stage_cfg(cfg, stage):
    return cfg.SOLVER if stage == "baseline" else cfg.SOLVER.STAGE2


def _build(case):
    cls = ReIDModel if case["stage"] == "baseline" else UniPromptReID
    model = cls(case["clip"], NC, camera_num=14, view_num=1)
    model.load_state_dict(case["state_dict"], strict=True)
    return model


def _center(case):
    cfg = _stage_cfg(case["cfg"], case["stage"])
    with_center = case["centers"] is not None
    return dict(center_weight=cfg.CENTER_LOSS_WEIGHT if with_center else None,
                center_lr=cfg.CENTER_LR if with_center else None)


def _grads(case, mesh):
    """Loss, accuracy, gradients, the centers' gradient and the BatchNorm
    buffers after the forward, on ``case``'s batch (this rank's block of it
    under ``mesh``), augmentation on."""
    cfg, stage = case["cfg"], case["stage"]
    model = _build(case)
    batch = case["batch"] if mesh is None else shard_batch(case["batch"], mesh)
    gen = torch.Generator().manual_seed(SEED)
    shard = None if mesh is None else (mesh.data, mesh.rank)
    x = train_augment(torch.from_numpy(batch["images"]), gen, **augment_args(cfg), shard=shard)
    opt = make_optimizer(_stage_cfg(cfg, stage), model, stage=stage)
    text = precompute_text_features(cfg, model, NC) if stage != "baseline" else None
    centers = None if case["centers"] is None else torch.from_numpy(case["centers"])
    loss, acc, grads, cgrad = loss_and_grads(
        model, cfg, make_loss(cfg, NC)[0], opt, x, torch.from_numpy(batch["pids"]).long(),
        centers=centers, center_weight=_center(case)["center_weight"], text_features=text,
        gen=gen, mesh=mesh)
    buffers = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    return {"loss": float(loss), "acc": float(acc), "grads": grads, "cgrad": cgrad,
            "buffers": buffers}


def _sgd_step(case, mesh):
    """One SGD step through ``make_train_step``, augmentation off → (loss,
    parameters after, centers after)."""
    cfg, stage = case["cfg_step"], case["stage"]
    model = _build(case)
    opt = make_optimizer(_stage_cfg(cfg, stage), model, stage=stage)
    text = precompute_text_features(cfg, model, NC) if stage != "baseline" else None
    centers = None if case["centers"] is None else torch.from_numpy(case["centers"])
    state = initial_state(model, opt, centers=centers)
    step = make_train_step(model, cfg, make_loss(cfg, NC)[0], opt, **_center(case),
                           uniprompt=text is not None, text_features=text, mesh=mesh)
    batch = case["batch"] if mesh is None else shard_batch(case["batch"], mesh)
    state, metrics = step(state, batch, LR, torch.Generator().manual_seed(0))
    return {"loss": float(metrics["loss"]),
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "centers": state.centers}


def _dp_job(cases):
    mesh = make_mesh()
    return {name: {"grads": _grads(case, mesh), "step": _sgd_step(case, mesh)}
            for name, case in cases.items()}


# ---------------------------------------------------------------------------
# the cases: weights from the JAX package's trees (seeded values), or the
# port's own init for RN50
# ---------------------------------------------------------------------------

def _cfgs(kind):
    """(JAX config, port config with augmentation on, port config of the SGD
    step with augmentation off), equal otherwise."""
    from tiny import tiny_cfg

    overrides = {"SOLVER.IMS_PER_BATCH": BATCH, "SOLVER.STAGE2.IMS_PER_BATCH": BATCH,
                 "INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                 "SOLVER.OPTIMIZER_NAME": "SGD", "SOLVER.STAGE2.OPTIMIZER_NAME": "SGD",
                 "SOLVER.WEIGHT_DECAY": 1e-4, "SOLVER.STAGE2.WEIGHT_DECAY": 1e-4}
    if kind == "baseline":
        overrides["MODEL.METRIC_LOSS_TYPE"] = "triplet_center"
    if kind == "moe2b":
        overrides.update({"MODEL.MOE.ENABLED": True, "MODEL.MOE.NUM_EXPERTS": E,
                          "MODEL.MOE.TOP_K": TOP_K, "MODEL.MOE.MOE_LAYERS": 2})
    if kind == "rn50":
        overrides.update({"MODEL.NAME": "RN50", "INPUT.SIZE_TRAIN": [64, 32]})
    jcfg = tiny_cfg(**overrides)
    step = get_default_cfg()
    step.merge_from_other_cfg(jcfg)
    step.MODEL.DEVICE = "cpu"
    aug = step.clone()
    aug.INPUT.PROB, aug.INPUT.PADDING, aug.INPUT.RE_PROB = 0.5, 4, 0.5
    return jcfg, aug, step


def _jax_pair(kind, jcfg):
    """(JAX model, seeded variables, port CLIPConfig, port state_dict)."""
    import jax

    from mpreid_tpu.models.factory import init_variables
    from mpreid_tpu.models.reid import ReIDModel as JaxReID
    from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUni
    from mpreid_tpu_torch.models import CLIPConfig, from_jax_variables
    from test_torch_moe import _seeded
    from tiny import tiny_clip_config

    clip = tiny_clip_config(**({"num_experts": E, "top_k": TOP_K, "moe_layers": 2}
                               if kind == "moe2b" else {}))
    cls = JaxReID if kind == "baseline" else JaxUni
    jmodel = cls(clip_config=clip, num_classes=NC, camera_num=14, view_num=1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), jcfg, abstract=True), 1)
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    return jmodel, variables, tclip, from_jax_variables(variables, tclip)


def _batch(hw, seed=3):
    rng = np.random.default_rng(seed)
    return {"images": rng.integers(0, 256, (BATCH, *hw, 3), dtype=np.uint8),
            "pids": np.repeat(np.arange(BATCH // 4), 4).astype(np.int32),
            "camids": rng.integers(0, 6, BATCH).astype(np.int32),
            "trackids": np.zeros(BATCH, np.int32)}


@functools.lru_cache(maxsize=None)
def _case(kind):
    jcfg, aug, step = _cfgs(kind)
    if kind == "rn50":
        model = ReIDModel(RN50_TINY, NC, camera_num=14, view_num=1)
        model.init_(torch.Generator().manual_seed(0))
        jax_side, clip, sd = None, RN50_TINY, model.state_dict()
    else:
        jmodel, variables, clip, sd = _jax_pair(kind, jcfg)
        jax_side = (jcfg, jmodel, variables)
    centers = np.random.default_rng(4).standard_normal((NC, 64)).astype(np.float32) \
        if kind == "baseline" else None
    case = {"cfg": aug, "cfg_step": step, "clip": clip, "state_dict": sd, "centers": centers,
            "stage": STAGE[kind], "batch": _batch(tuple(step.INPUT.SIZE_TRAIN))}
    return case, jax_side


@pytest.fixture(scope="module")
def ranks():
    cases = {kind: _case(kind)[0] for kind in CASES}
    return spawn(_dp_job, WORLD, (cases,), timeout=240, threads=2)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_grads_close(got, want):
    floor = 1e-3 * max(float(np.linalg.norm(_np(g))) for g in want.values())
    for name, g in want.items():
        diff = float(np.linalg.norm(_np(got[name]) - _np(g)))
        assert diff <= TOL * max(float(np.linalg.norm(_np(g))), floor), (name, diff)


@pytest.mark.parametrize("kind", CASES)
def test_dp_gradients_equal_the_single_process_step(ranks, kind):
    want = _grads(_case(kind)[0], None)
    for out in ranks:
        got = out[kind]["grads"]
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert got["acc"] == want["acc"]
        assert set(got["grads"]) == set(want["grads"])
        _assert_grads_close(got["grads"], want["grads"])
        if want["cgrad"] is not None:
            torch.testing.assert_close(got["cgrad"], want["cgrad"], rtol=TOL, atol=1e-8)
        assert set(got["buffers"]) == set(want["buffers"]) and want["buffers"]
        for k, v in want["buffers"].items():
            torch.testing.assert_close(got["buffers"][k], v, rtol=TOL, atol=1e-6, msg=k)


@pytest.mark.parametrize("kind", CASES)
def test_dp_step_equals_the_single_process_step_and_is_replicated(ranks, kind):
    want = _sgd_step(_case(kind)[0], None)
    r0, r1 = (out[kind]["step"] for out in ranks)
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - want["loss"]) <= TOL * abs(want["loss"])
    for name, p in want["params"].items():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
        torch.testing.assert_close(r0["params"][name], p, rtol=TOL, atol=1e-7, msg=name)
    if want["centers"] is not None:
        torch.testing.assert_close(r0["centers"], want["centers"], rtol=TOL, atol=1e-7)


def _jax_mesh_step(kind, case, jax_side):
    """The JAX package's SGD step over make_mesh(data=8) → (loss, port-named
    parameters after, centers after)."""
    import jax
    import jax.numpy as jnp

    from mpreid_tpu.engine import uniprompt as juni
    from mpreid_tpu.engine.steps import make_train_step as jax_make_train_step
    from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
    from mpreid_tpu.losses import make_loss as jax_make_loss
    from mpreid_tpu.parallel import make_mesh as jax_make_mesh
    from mpreid_tpu.parallel import shard_batch as jax_shard_batch
    from mpreid_tpu.parallel import shard_variables
    from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
    from mpreid_tpu_torch.models import from_jax_variables

    jcfg, jmodel, variables = jax_side
    stage = case["stage"]
    uniprompt = stage != "baseline"
    jopt = jax_make_optimizer(_stage_cfg(jcfg, stage), variables["params"], stage=stage)
    text = jnp.asarray(juni.precompute_text_features(jcfg, jmodel, variables, NC)) \
        if uniprompt else None
    center = {k: v for k, v in _center(case).items()}
    step = jax_make_train_step(jmodel, jcfg, jax_make_loss(jcfg, NC)[0], jopt, **center,
                               uniprompt=uniprompt, text_features=text)
    mesh = jax_make_mesh(data=8, model=1)
    with mesh:
        state = jax_initial_state(shard_variables(variables, mesh), jopt,
                                  centers=None if case["centers"] is None
                                  else jnp.asarray(case["centers"]))
        state, metrics = step(state, jax_shard_batch(case["batch"], mesh), LR,
                              jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(np.asarray, state.params)
        stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
        centers = None if state.centers is None else np.asarray(state.centers)
    model = _build(dict(case, state_dict=from_jax_variables(
        {"params": params, "batch_stats": stats}, case["clip"])))
    return float(metrics["loss"]), dict(model.named_parameters()), centers


@pytest.mark.parametrize("kind", ["baseline", "stage2a", "moe2b"])
def test_dp_step_equals_the_jax_mesh_step(ranks, kind):
    case, jax_side = _case(kind)
    jloss, jparams, jcenters = _jax_mesh_step(kind, case, jax_side)
    got = ranks[0][kind]["step"]
    assert np.isclose(got["loss"], jloss, rtol=1e-4), (got["loss"], jloss)
    for name, p in jparams.items():
        np.testing.assert_allclose(_np(got["params"][name]), _np(p), rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    if jcenters is not None:
        np.testing.assert_allclose(_np(got["centers"]), jcenters, rtol=1e-4, atol=1e-6)
