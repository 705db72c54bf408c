"""The port's model axis (tensor and expert parallelism) against one process and the JAX package.

Two gloo jobs on the CPU (``parallel.launch.spawn``, one per mesh shape for
the module): two ranks on a 1 × 2 mesh and four on a 2 × 2 mesh. Each rank
slices a tiny model (``parallel.shard_module``: the towers' Megatron pairs
under ``tp_towers``, the classifiers by class, 7 classes over two ranks:
4 + 3, the MoE experts, ``ctx_generic``) and runs the step; every result
must be the single-process one, as GSPMD's is in the JAX package
(tests/test_parallel.py::TestTensorParallelTowers). The JAX package's
``device_put`` refuses a class axis that its model axis does not divide, so
the cases held against it have 8 classes:

* placements equal the JAX package's ``shard_variables`` on its 4 × 2 CPU
  mesh, leaf by leaf (the weights carried across by ``from_jax_variables``),
  each rank's ``in_proj`` rows the q, k and v rows of JAX's local heads, a
  margin head's weight replicated;
* the class-parallel cross entropy and label smoothing against the whole
  logits' loss and gradient;
* the TP-towers, EP (with and without TP towers) and 2-D baseline, stage-2a
  and stage-2b steps: fp32 loss to 1e-5 relative, every gathered gradient
  to 1e-5 norm-relative (floored at 1e-2 of the largest leaf's norm), the
  parameters after an SGD step within JAX's own rtol 2e-4 / atol 2e-5;
  against the JAX package's 4 × 2-mesh TP step from the same weights
  (augmentation off): loss rtol 1e-4, parameters rtol 2e-4 / atol 2e-5;
* a replicated parameter's gradient equal, bit for bit, on the ranks of a
  model group; ZeRO-1 on the 2 × 2 mesh bit for bit against the model axis
  alone;
* checkpoints: a model-axis run's whole state loads into one process, and
  one process's resumes under the model axis;
* ``do_train`` and ``do_train_stage2`` with ``TPU.MESH_MODEL 2``
  (``TP_TOWERS`` on and off, dense and MoE) end where one process ends.

The tiny CLIP is 128 wide in both towers (two heads each: the port splits
whole heads, and ``TPU.MESH_MODEL`` must divide them). This module imports
nothing of JAX at its top: the spawned ranks import it to find their function.
"""

import contextlib
import dataclasses
import functools
import logging
import os

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import (
    do_train, do_train_stage2, initial_state, loss_and_grads, make_train_step,
    precompute_text_features,
)
from mpreid_tpu_torch.engine.processor import checkpoint_state
from mpreid_tpu_torch.engine.steps import augment_args
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.losses.softmax import cross_entropy, cross_entropy_label_smooth
from mpreid_tpu_torch.models import ReIDModel, UniPromptReID
from mpreid_tpu_torch.ops.augment import train_augment
from mpreid_tpu_torch.parallel import (
    gather_whole, make_mesh, model_specs, shard_batch, shard_module, sharded_params,
    zero_sharded,
)
from mpreid_tpu_torch.parallel.launch import spawn
from mpreid_tpu_torch.solver import make_optimizer
from mpreid_tpu_torch.utils.checkpoint import load_checkpoint, restore_state, save_checkpoint

BATCH, NC, NC_JAX, E, TOP_K = 16, 7, 8, 4, 2
LR, SEED, TOL = 1e-3, 5, 1e-5
CLIP = dict(vision_width=128, transformer_width=128, transformer_heads=2)
KINDS = {  # name: (stage, MoE, tp_towers)
    "baseline": ("baseline", False, True),
    "stage2a": ("stage2a", False, True),
    "moe2b": ("stage2b", True, True),
    "moe2b_ep_only": ("stage2b", True, False),
}
CASES_2X2 = ("baseline", "moe2b")
JAX_KINDS = ("baseline", "moe2b")


def _stage_cfg(cfg, stage):
    return cfg.SOLVER if stage == "baseline" else cfg.SOLVER.STAGE2


def _build(case):
    cls = ReIDModel if case["stage"] == "baseline" else UniPromptReID
    model = cls(case["clip"], case["nc"], camera_num=14, view_num=1)
    model.load_state_dict(case["state_dict"], strict=True)
    return model


def _run(case, mesh):
    """Loss, accuracy and whole gradients of one forward (augmentation on),
    then the loss and whole parameters after one SGD step (augmentation
    off), on ``case``'s batch (this rank's block of it under a data axis)."""
    stage, tp, nc = case["stage"], case["tp_towers"], case["nc"]
    out = {}
    for part, cfg in (("grads", case["cfg"]), ("step", case["cfg_step"])):
        model = _build(case)
        opt = make_optimizer(_stage_cfg(cfg, stage), model, stage=stage)
        text = precompute_text_features(cfg, model, nc) if stage != "baseline" else None
        if mesh is not None:
            shard_module(model, mesh, tp)
        dp = mesh is not None and mesh.data > 1
        batch = shard_batch(case["batch"], mesh) if dp else case["batch"]
        loss_fn = make_loss(cfg, nc)[0]
        if part == "grads":
            gen = torch.Generator().manual_seed(SEED)
            x = train_augment(torch.from_numpy(batch["images"]), gen, **augment_args(cfg),
                              shard=(mesh.data, mesh.rank) if dp else None)
            loss, acc, grads, _ = loss_and_grads(
                model, cfg, loss_fn, opt, x, torch.from_numpy(batch["pids"]).long(),
                text_features=text, gen=gen, mesh=mesh)
            sliced = sharded_params(model)
            out["grads"] = {"loss": float(loss), "acc": float(acc),
                            "grads": gather_whole(grads, model),
                            "replicated": {k: g for k, g in grads.items() if k not in sliced}}
        else:
            state = initial_state(model, opt)
            step = make_train_step(model, cfg, loss_fn, opt, uniprompt=text is not None,
                                   text_features=text, mesh=mesh)
            state, metrics = step(state, batch, LR, torch.Generator().manual_seed(0))
            out["step"] = {"loss": float(metrics["loss"]), "params": gather_whole(
                {k: p.detach() for k, p in model.named_parameters()}, model)}
    return out


def _zero_bitwise(case, mesh):
    """Two Adam steps on the 2 × 2 mesh with and without ZeRO-1 → (whole
    parameters, whole moments) of each."""
    cfg = case["cfg_step"].clone()
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    res = {}
    for zero in (False, True):
        model = _build(case)
        shard_module(model, mesh, True)
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        opt = zero_sharded(opt, mesh, model, tp_towers=True) if zero else opt
        state = initial_state(model, opt)
        step = make_train_step(model, cfg, make_loss(cfg, NC)[0], opt, mesh=mesh)
        gen = torch.Generator().manual_seed(0)
        for _ in range(2):
            state, _ = step(state, shard_batch(case["batch"], mesh), LR, gen)
        whole = checkpoint_state(state, opt)
        res[zero] = ({k: p.detach() for k, p in gather_whole(
            dict(model.named_parameters()), model).items()},
            dict(whole.opt_state.mu), dict(whole.opt_state.nu),
            len(getattr(opt, "zero_keys", ())))
    return res


def _ce_cases(mesh):
    """Class-parallel CE and label smoothing of this rank's columns of seeded
    (B, 7) logits → (losses, this rank's columns of the gradients)."""
    from mpreid_tpu_torch.parallel import Split

    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(12, NC, generator=gen) * 3
    target = torch.randint(0, NC, (12,), generator=gen)
    split = Split(1, (4, 3), 1, (12, NC), mesh.model_axis)
    out = {}
    for name, fn in (("ce", cross_entropy),
                     ("smooth", lambda x, t, s: cross_entropy_label_smooth(x, t, NC, split=s))):
        local = split.local(logits).clone().requires_grad_(True)
        loss = fn(local, target, split)
        loss.backward()
        out[name] = (loss.item(), local.grad, split.offset)
    return out, logits, target


def _margin_placement(case, mesh):
    model = ReIDModel(case["clip"], NC, camera_num=14, view_num=1, cos_layer="arcface")
    model.init_(torch.Generator().manual_seed(0))
    specs = model_specs(model, True)
    shard_module(model, mesh, True)
    return specs, {k: tuple(p.shape) for k, p in model.named_parameters()
                   if "classifier" in k}


def _in_proj_slices(case, mesh):
    model = _build(case)
    shard_module(model, mesh, True)
    return {k: p.detach().clone() for k, p in model.named_parameters()
            if k.endswith("resblocks.0.attn.in_proj_weight")}


def _job_1x2(cases, jax_cases, paths):
    mesh = make_mesh(data=1, model=2)
    out = {name: _run(case, mesh) for name, case in cases.items()}
    out["ce"] = _ce_cases(mesh)[0]
    out["margin"] = _margin_placement(cases["baseline"], mesh)
    out["in_proj"] = _in_proj_slices(jax_cases["baseline"], mesh)
    out["checkpoint"] = _checkpoint_job(cases["baseline"], mesh, paths)
    out["train"] = _train_job(paths)
    return out


def _job_2x2(cases, jax_cases):
    mesh = make_mesh(data=2, model=2)
    out = {name: _run(case, mesh) for name, case in cases.items()}
    out["jax"] = {name: _run(case, mesh)["step"] for name, case in jax_cases.items()}
    out["zero"] = _zero_bitwise(cases["baseline"], mesh)
    out["coords"] = (mesh.rank, mesh.model_rank)
    return out


# ---------------------------------------------------------------------------
# the cases: weights from the JAX package's trees (seeded values)
# ---------------------------------------------------------------------------

def _cfgs(kind):
    """(JAX config, port config with augmentation on, port config of the SGD
    step with augmentation off), equal otherwise."""
    from tiny import tiny_cfg

    overrides = {"SOLVER.IMS_PER_BATCH": BATCH, "SOLVER.STAGE2.IMS_PER_BATCH": BATCH,
                 "INPUT.PROB": 0.0, "INPUT.PADDING": 0, "INPUT.RE_PROB": 0.0,
                 "SOLVER.OPTIMIZER_NAME": "SGD", "SOLVER.STAGE2.OPTIMIZER_NAME": "SGD",
                 "SOLVER.WEIGHT_DECAY": 1e-4, "SOLVER.STAGE2.WEIGHT_DECAY": 1e-4}
    if KINDS[kind][1]:
        overrides.update({"MODEL.MOE.ENABLED": True, "MODEL.MOE.NUM_EXPERTS": E,
                          "MODEL.MOE.TOP_K": TOP_K, "MODEL.MOE.MOE_LAYERS": 2})
    jcfg = tiny_cfg(**overrides)
    step = get_default_cfg()
    step.merge_from_other_cfg(jcfg)
    step.MODEL.DEVICE = "cpu"
    aug = step.clone()
    aug.INPUT.PROB, aug.INPUT.PADDING, aug.INPUT.RE_PROB = 0.5, 4, 0.5
    return jcfg, aug, step


@functools.lru_cache(maxsize=None)
def _case(kind, nc=NC):
    import jax

    from mpreid_tpu.models.factory import init_variables
    from mpreid_tpu.models.reid import ReIDModel as JaxReID
    from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUni
    from mpreid_tpu_torch.models import CLIPConfig, from_jax_variables
    from test_torch_moe import _seeded
    from tiny import tiny_clip_config

    stage, moe, tp = KINDS[kind]
    jcfg, aug, step = _cfgs(kind)
    clip = tiny_clip_config(**CLIP, **({"num_experts": E, "top_k": TOP_K, "moe_layers": 2}
                                       if moe else {}))
    cls = JaxReID if stage == "baseline" else JaxUni
    jmodel = cls(clip_config=clip, num_classes=nc, camera_num=14, view_num=1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), jcfg, abstract=True), 1)
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    rng = np.random.default_rng(3)
    batch = {"images": rng.integers(0, 256, (BATCH, 32, 16, 3), dtype=np.uint8),
             "pids": np.repeat(np.arange(BATCH // 4), 4).astype(np.int32),
             "camids": rng.integers(0, 6, BATCH).astype(np.int32),
             "trackids": np.zeros(BATCH, np.int32)}
    case = {"cfg": aug, "cfg_step": step, "clip": tclip, "stage": stage, "tp_towers": tp,
            "nc": nc, "state_dict": from_jax_variables(variables, tclip), "batch": batch}
    return case, (jcfg, jmodel, variables)


@pytest.fixture(scope="module")
def paths(tmp_path_factory, market, mmmp):
    """Files the two-rank job reads and writes; the one-process checkpoints
    it resumes from are written here, before it starts."""
    root = tmp_path_factory.mktemp("model_axis")
    one = _one_process_checkpoint(_case("baseline")[0], str(root / "one.pth"))
    out = {"tp_ckpt": str(root / "tp.pth"), "one_ckpt": str(root / "one.pth"),
           "one_state": one, "market": market, "mmmp": mmmp, "out": str(root / "out")}
    cfg = _loop_cfg(market)
    cfg.OUTPUT_DIR = os.path.join(out["out"], "one")
    cfg.SOLVER.CHECKPOINT_PERIOD = 1
    _loop(cfg)
    return out


def _jax_cases():
    return {kind: _case(kind, NC_JAX)[0] for kind in JAX_KINDS}


@pytest.fixture(scope="module")
def ranks_1x2(paths):
    cases = {kind: _case(kind)[0] for kind in KINDS}
    return spawn(_job_1x2, 2, (cases, _jax_cases(), paths), timeout=300, threads=2)


@pytest.fixture(scope="module")
def ranks_2x2():
    cases = {kind: _case(kind)[0] for kind in CASES_2X2}
    return spawn(_job_2x2, 4, (cases, _jax_cases()), timeout=300, threads=1)


def _mesh_ranks(mesh, ranks_1x2, ranks_2x2):
    return ranks_1x2 if mesh == "1x2" else ranks_2x2


def _np(t):
    return t.detach().float().numpy()


def _assert_grads_close(got, want):
    # a leaf whose exact gradient is zero (a bias that a BatchNorm in train
    # mode cancels: ``ln_post.bias``) holds rounding noise of the other
    # leaves' scale, so each leaf's norm is floored at 1e-2 of the largest's
    floor = 1e-2 * max(float(np.linalg.norm(_np(g))) for g in want.values())
    for name, g in want.items():
        diff = float(np.linalg.norm(_np(got[name]) - _np(g)))
        assert diff <= TOL * max(float(np.linalg.norm(_np(g))), floor), (name, diff)


@functools.lru_cache(maxsize=None)
def _one_process(kind):
    return _run(_case(kind)[0], None)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

def _jax_placements(kind, tp_towers):
    """{port name: split?} from the JAX package's ``shard_variables`` on the
    4 × 2 mesh: each JAX leaf filled with its own constant and carried
    across, so a port parameter's values name the leaves it came from."""
    import jax
    from jax.sharding import PartitionSpec as P

    from mpreid_tpu.ops.attention import set_tp_sharded_towers
    from mpreid_tpu.parallel import make_mesh as jax_make_mesh
    from mpreid_tpu.parallel import shard_variables
    from mpreid_tpu_torch.models import from_jax_variables

    case, (_, _, variables) = _case(kind, NC_JAX)
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    filled = [np.full(np.shape(x), i + 1, np.float32) for i, x in enumerate(leaves)]
    try:
        placed = shard_variables({"params": jax.tree_util.tree_unflatten(treedef, filled)},
                                 jax_make_mesh(data=4, model=2), tp_towers=tp_towers)
    finally:
        set_tp_sharded_towers(False)  # the JAX package's sticky interlock, as its tests reset it
    split = [x.sharding.spec != P() for x in jax.tree_util.tree_leaves(placed["params"])]
    stats = jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32),
                                   variables["batch_stats"])
    model = _build(dict(case, state_dict=from_jax_variables(
        {"params": jax.tree_util.tree_unflatten(treedef, filled), "batch_stats": stats},
        case["clip"])))
    out = {}
    for name, p in model.named_parameters():
        ids = {int(v) for v in torch.unique(p.detach()).tolist() if v >= 1 and float(v).is_integer()}
        if ids:
            out[name] = {split[i - 1] for i in ids}
    return model, out


@pytest.mark.parametrize("tp_towers", [False, True])
@pytest.mark.parametrize("kind", ["baseline", "stage2a", "moe2b"])
def test_placements_equal_jax_shard_variables(kind, tp_towers):
    model, jax_split = _jax_placements(kind, tp_towers)
    specs = model_specs(model, tp_towers)
    assert len(jax_split) >= len(specs) - 8  # the template buffers the port derives
    for name, want in jax_split.items():
        assert want == {bool(any(specs[name]))}, (name, specs[name], want)
    split = sum(bool(any(s)) for s in specs.values())
    assert split >= {"baseline": 2, "stage2a": 3, "moe2b": 11}[kind] + 6 * tp_towers


def test_in_proj_slices_are_jax_local_heads(ranks_1x2):
    """Rank m's ``in_proj`` rows are the q, k and v rows of the heads JAX
    device (0, m) holds: its column shard of the head-major kernel."""
    import jax

    from mpreid_tpu.ops.attention import set_tp_sharded_towers
    from mpreid_tpu.parallel import make_mesh as jax_make_mesh
    from mpreid_tpu.parallel import shard_variables
    from mpreid_tpu_torch.ops.attention import head_major_perm_inverse

    case, (_, _, variables) = _case("baseline", NC_JAX)
    mesh = jax_make_mesh(data=4, model=2)
    try:
        placed = shard_variables(variables, mesh, tp_towers=True)
    finally:
        set_tp_sharded_towers(False)
    kernel = placed["params"]["visual"]["resblocks_0"]["attn"]["in_proj_kernel"]
    d, heads = kernel.shape[0], case["clip"].vision_width // 64
    for m, out in enumerate(ranks_1x2):
        local = out["in_proj"]["image_encoder.transformer.resblocks.0.attn.in_proj_weight"]
        device = mesh.devices[0, m]
        shard = next(s for s in kernel.addressable_shards if s.device == device)
        cols = np.asarray(shard.data)[:, head_major_perm_inverse(d // 2, heads // 2)]
        np.testing.assert_array_equal(local.numpy(), cols.T)


def test_margin_head_weight_stays_replicated(ranks_1x2):
    """A margin head's weight is the JAX package's ``weight`` leaf, which its
    ``param_spec`` replicates (it splits ``kernel`` leaves only)."""
    from jax.sharding import PartitionSpec as P

    from mpreid_tpu.parallel.mesh import param_spec as jax_param_spec

    assert jax_param_spec("classifier/weight", True) == P()
    for out in ranks_1x2:
        specs, shapes = out["margin"]
        assert specs["classifier.weight"] == () and specs["classifier_proj.weight"] == ()
        assert shapes == {"classifier.weight": (NC, 128 * 1), "classifier_proj.weight": (NC, 32)}


@pytest.mark.parametrize("what,clip,message", [
    ("heads", dict(vision_width=64), "TPU.MESH_MODEL 2 does not divide the 1 heads of "
     "image_encoder.transformer.resblocks.0.attn"),
    ("experts", dict(num_experts=3, top_k=2, moe_layers=1),
     "TPU.MESH_MODEL 2 does not divide the MODEL.MOE.NUM_EXPERTS 3 experts")])
def test_a_model_axis_that_does_not_divide_raises_naming_the_key(what, clip, message):
    from mpreid_tpu_torch.models import VIT_B16
    from mpreid_tpu_torch.parallel import Mesh

    config = dataclasses.replace(VIT_B16, embed_dim=32, vision_layers=2, h_resolution=2,
                                 w_resolution=1, **{**CLIP, **clip})
    model = ReIDModel(config, NC, camera_num=14, view_num=1)
    with pytest.raises(ValueError, match=message):
        shard_module(model, Mesh(1, 2), tp_towers=True)


# ---------------------------------------------------------------------------
# the class-parallel losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ce", "smooth"])
def test_class_parallel_losses_equal_the_whole_logits(ranks_1x2, name):
    from mpreid_tpu_torch.parallel import Mesh

    _, logits, target = _ce_cases(Mesh(1, 2))
    whole = logits.clone().requires_grad_(True)
    fn = cross_entropy if name == "ce" else (lambda x, t: cross_entropy_label_smooth(x, t, NC))
    want = fn(whole, target)
    want.backward()
    for out in ranks_1x2:
        loss, grad, lo = out["ce"][name]
        assert abs(loss - float(want)) <= 1e-6 * abs(float(want))
        torch.testing.assert_close(grad, whole.grad[:, lo:lo + grad.shape[1]], rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the steps against one process
# ---------------------------------------------------------------------------

STEP_CASES = [("1x2", k) for k in KINDS] + [("2x2", k) for k in CASES_2X2]


@pytest.mark.parametrize("mesh,kind", STEP_CASES)
def test_model_axis_gradients_equal_one_process(ranks_1x2, ranks_2x2, mesh, kind):
    want = _one_process(kind)["grads"]
    for out in _mesh_ranks(mesh, ranks_1x2, ranks_2x2):
        got = out[kind]["grads"]
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        assert got["acc"] == want["acc"]
        assert set(got["grads"]) == set(want["grads"])
        _assert_grads_close(got["grads"], want["grads"])


@pytest.mark.parametrize("mesh,kind", STEP_CASES)
def test_model_axis_step_equals_one_process(ranks_1x2, ranks_2x2, mesh, kind):
    want = _one_process(kind)["step"]
    for out in _mesh_ranks(mesh, ranks_1x2, ranks_2x2):
        got = out[kind]["step"]
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        for name, p in want["params"].items():
            np.testing.assert_allclose(_np(got["params"][name]), _np(p), rtol=2e-4, atol=2e-5,
                                       err_msg=name)


@pytest.mark.parametrize("mesh,kind", STEP_CASES)
def test_replicated_gradients_equal_across_model_ranks(ranks_1x2, ranks_2x2, mesh, kind):
    ranks = _mesh_ranks(mesh, ranks_1x2, ranks_2x2)
    for lo in range(0, len(ranks), 2):  # the model groups: ranks (2d, 2d + 1)
        a, b = (ranks[lo + m][kind]["grads"]["replicated"] for m in range(2))
        assert a and set(a) == set(b)
        for name, g in a.items():
            assert torch.equal(g, b[name]), name


def _jax_tp_step(kind):
    """The JAX package's SGD step on its 4 × 2 mesh with tensor-parallel
    towers (tests/test_parallel.py::test_tp_step_matches_single_device) →
    (loss, port-named parameters after)."""
    import jax
    import jax.numpy as jnp

    from mpreid_tpu.engine import uniprompt as juni
    from mpreid_tpu.engine.steps import make_train_step as jax_make_train_step
    from mpreid_tpu.engine.train_state import initial_state as jax_initial_state
    from mpreid_tpu.losses import make_loss as jax_make_loss
    from mpreid_tpu.ops.attention import set_tp_sharded_towers
    from mpreid_tpu.parallel import make_mesh as jax_make_mesh
    from mpreid_tpu.parallel import shard_batch as jax_shard_batch
    from mpreid_tpu.parallel import shard_variables
    from mpreid_tpu.solver import make_optimizer as jax_make_optimizer
    from mpreid_tpu_torch.models import from_jax_variables

    case, (jcfg, jmodel, variables) = _case(kind, NC_JAX)
    stage = case["stage"]
    uniprompt = stage != "baseline"
    jopt = jax_make_optimizer(_stage_cfg(jcfg, stage), variables["params"], stage=stage)
    text = jnp.asarray(juni.precompute_text_features(jcfg, jmodel, variables, NC_JAX)) \
        if uniprompt else None
    step = jax_make_train_step(jmodel, jcfg, jax_make_loss(jcfg, NC_JAX)[0], jopt,
                               uniprompt=uniprompt, text_features=text)
    mesh = jax_make_mesh(data=4, model=2)
    try:
        with mesh:
            state = jax_initial_state(shard_variables(variables, mesh, tp_towers=True), jopt)
            state, metrics = step(state, jax_shard_batch(case["batch"], mesh), LR,
                                  jax.random.PRNGKey(0))
            params = jax.tree_util.tree_map(np.asarray, state.params)
            stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
    finally:
        set_tp_sharded_towers(False)
    model = _build(dict(case, state_dict=from_jax_variables(
        {"params": params, "batch_stats": stats}, case["clip"])))
    return float(metrics["loss"]), dict(model.named_parameters())


@pytest.mark.parametrize("kind", JAX_KINDS)
def test_model_axis_step_equals_the_jax_tp_step(ranks_2x2, kind):
    jloss, jparams = _jax_tp_step(kind)
    for got in (out["jax"][kind] for out in ranks_2x2):
        assert np.isclose(got["loss"], jloss, rtol=1e-4), (got["loss"], jloss)
        for name, p in jparams.items():
            np.testing.assert_allclose(_np(got["params"][name]), _np(p), rtol=2e-4, atol=2e-5,
                                       err_msg=name)


def test_zero_with_the_model_axis_is_bitwise(ranks_2x2):
    for out in ranks_2x2:
        (p0, mu0, nu0, k0), (p1, mu1, nu1, k1) = out["zero"][False], out["zero"][True]
        assert k0 == 0 and k1 > 0
        for a, b in ((p0, p1), (mu0, mu1), (nu0, nu1)):
            assert set(a) == set(b) and all(torch.equal(v, b[k]) for k, v in a.items())
    assert sorted(out["coords"] for out in ranks_2x2) == [(0, 0), (0, 1), (1, 0), (1, 1)]


# ---------------------------------------------------------------------------
# checkpoints and the training loops
# ---------------------------------------------------------------------------

def _adam_state(case, mesh):
    """The baseline model after one Adam step (sliced over ``mesh``'s model
    axis when given) → (model, optimizer, state)."""
    cfg = case["cfg_step"].clone()
    cfg.SOLVER.OPTIMIZER_NAME = "Adam"
    model = _build(case)
    if mesh is not None:
        shard_module(model, mesh, True)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    state = initial_state(model, opt)
    step = make_train_step(model, cfg, make_loss(cfg, NC)[0], opt, mesh=mesh)
    state, _ = step(state, case["batch"], LR, torch.Generator().manual_seed(0))
    return model, opt, state


def _one_process_checkpoint(case, path):
    _, _, state = _adam_state(case, None)
    save_checkpoint(path, state, 1)
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def _checkpoint_job(case, mesh, paths):
    """A model-axis state written whole by rank 0; one process's checkpoint
    restored under the model axis → the restored whole tensors."""
    from mpreid_tpu_torch.parallel import full_state_dict

    model, opt, state = _adam_state(case, mesh)
    saved = checkpoint_state(state, opt)
    if mesh.model_rank == 0:
        save_checkpoint(paths["tp_ckpt"], saved, 1)
    torch.distributed.barrier()
    written = {k: v.clone() for k, v in saved.model_state.items()}
    model, opt, state = _adam_state(case, mesh)
    epoch = restore_state(state, load_checkpoint(paths["one_ckpt"]), opt)
    whole = checkpoint_state(state, opt)
    return {"written": written, "restored": full_state_dict(model), "epoch": epoch,
            "mu": dict(whole.opt_state.mu), "local_mu": {k: tuple(v.shape) for k, v in
                                                         state.opt_state.mu.items()}}


def test_model_axis_checkpoint_loads_in_one_process(ranks_1x2, paths):
    payload = load_checkpoint(paths["tp_ckpt"])
    model = _build(_case("baseline")[0])
    model.load_state_dict(payload["model"], strict=True)  # whole tensors, one process's keys
    for k, v in model.state_dict().items():
        assert torch.equal(v, ranks_1x2[0]["checkpoint"]["written"][k]), k
    params = dict(model.named_parameters())
    for k, m in payload["opt_state"]["mu"].items():
        assert m.shape == params[k].shape, k


def test_one_process_checkpoint_resumes_under_the_model_axis(ranks_1x2, paths):
    payload = load_checkpoint(paths["one_ckpt"])
    for out in ranks_1x2:
        ck = out["checkpoint"]
        assert ck["epoch"] == 1
        for k, v in paths["one_state"].items():
            assert torch.equal(ck["restored"][k], v), k
        for k, m in payload["opt_state"]["mu"].items():
            assert torch.equal(ck["mu"][k], m), k
        w = "image_encoder.transformer.resblocks.0.attn.in_proj_weight"
        assert ck["local_mu"][w] == (3 * 128 // 2, 128)  # the rank's slice


@pytest.fixture(scope="module")
def market(tmp_path_factory):
    from mpreid_tpu_torch.data.synthetic import make_market1501

    root = tmp_path_factory.mktemp("m1501_model_axis")
    make_market1501(str(root), n_ids=6, imgs_per_id=8)
    return str(root)


@pytest.fixture(scope="module")
def mmmp(tmp_path_factory):
    from mpreid_tpu_torch.data.synthetic import make_mmmp

    root = tmp_path_factory.mktemp("mmmp_model_axis")
    make_mmmp(str(root))
    return str(root)


def _loop_cfg(root, names="market1501", moe=False, **tpu):
    from tiny import tiny_cfg

    cfg = get_default_cfg()
    cfg.merge_from_other_cfg(tiny_cfg())
    cfg.MODEL.DEVICE = "cpu"
    cfg.DATASETS.NAMES = names
    cfg.DATASETS.ROOT_DIR = root
    cfg.DATASETS.EXP_SETTING = "exp_cctv_ir_cctv_rgb"
    cfg.OUTPUT_DIR = ""
    cfg.SOLVER.OPTIMIZER_NAME = cfg.SOLVER.STAGE2.OPTIMIZER_NAME = "SGD"
    cfg.SOLVER.EVAL_PERIOD = cfg.SOLVER.STAGE2.EVAL_PERIOD = 100
    cfg.SOLVER.STAGE2.IMS_PER_BATCH = 8
    if moe:
        cfg.MODEL.MOE.ENABLED = True
        cfg.MODEL.MOE.NUM_EXPERTS, cfg.MODEL.MOE.TOP_K, cfg.MODEL.MOE.MOE_LAYERS = E, TOP_K, 2
    for key, value in tpu.items():
        cfg.TPU[key] = value
    return cfg


@contextlib.contextmanager
def _tiny_vit():
    """Within the block the factory's ViT-B/16 is the module's tiny two-head
    CLIP (the training loops build their model by name)."""
    from mpreid_tpu_torch.models import factory

    full = factory._BASE_CONFIGS["ViT-B-16"]
    factory._BASE_CONFIGS["ViT-B-16"] = dataclasses.replace(
        full, embed_dim=32, vision_layers=2, transformer_layers=2, **CLIP)
    try:
        yield
    finally:
        factory._BASE_CONFIGS["ViT-B-16"] = full


def _loop(cfg, stage2=False, epochs=1):
    from mpreid_tpu_torch.data import make_dataloader
    from mpreid_tpu_torch.models import make_model, make_model_uniprompt

    from mpreid_tpu_torch.parallel import full_state_dict

    tl, _, _, nq, ncls, ncam, nview = make_dataloader(cfg)
    with _tiny_vit():
        if stage2:
            model = make_model_uniprompt(cfg, ncls, ncam, nview)
        else:
            model = make_model(cfg, ncls, ncam, nview)
    if stage2:
        opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2b" if
                             cfg.MODEL.MOE.ENABLED else "stage2a")
        _, history = do_train_stage2(cfg, model, tl, None, opt, lambda e: 1e-3,
                                     make_loss(cfg, ncls)[0], nq, ncls, max_epochs=epochs)
    else:
        opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
        _, history = do_train(cfg, model, tl, None, opt, lambda e: 1e-3,
                              make_loss(cfg, ncls)[0], nq, max_epochs=epochs)
    return history, full_state_dict(model)


def _loop_cfgs(paths):
    m, s = paths["market"], paths["mmmp"]
    resume = _loop_cfg(m, MESH_MODEL=2, TP_TOWERS=True)
    resume.SOLVER.RESUME = os.path.join(paths["out"], "one", "ViT-B-16_1.pth")
    return {"tp": (_loop_cfg(m, MESH_MODEL=2, TP_TOWERS=True), False, 1),
            "classes_only": (_loop_cfg(m, MESH_MODEL=2), False, 1),
            "resumed": (resume, False, 2),
            "stage2_moe": (_loop_cfg(s, "mmmp", moe=True, MESH_MODEL=2, TP_TOWERS=True), True, 1),
            "stage2_ep_only": (_loop_cfg(s, "mmmp", moe=True, MESH_MODEL=2), True, 1)}


def _train_job(paths):
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("mpreid_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(Keep())
    out = {name: _loop(cfg, stage2, epochs) for name, (cfg, stage2, epochs)
           in _loop_cfgs(paths).items()}
    out["logs"] = records
    return out


@pytest.fixture(scope="module")
def one_process_loops(paths):
    """The same loops in one process (where the mesh keys do nothing)."""
    return {name: _loop(cfg, stage2, epochs)
            for name, (cfg, stage2, epochs) in _loop_cfgs(paths).items()}


@pytest.mark.parametrize("name", ["tp", "classes_only", "resumed", "stage2_moe",
                                  "stage2_ep_only"])
def test_training_loops_under_the_model_axis_equal_one_process(ranks_1x2, one_process_loops,
                                                               name):
    history, state = one_process_loops[name]
    for out in ranks_1x2:
        got_history, got_state = out["train"][name]
        assert [h["epoch"] for h in got_history] == [h["epoch"] for h in history]
        for got, want in zip(got_history, history):
            assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        for k, v in state.items():
            np.testing.assert_allclose(_np(got_state[k]), _np(v), rtol=2e-4, atol=2e-5,
                                       err_msg=k)


def test_training_over_the_model_axis_logs_its_mesh(ranks_1x2):
    messages = ranks_1x2[0]["train"]["logs"]
    assert any(m.startswith("Training over mesh {'data': 1, 'model': 2} with tensor-parallel "
                            "towers") for m in messages)
    assert any(m.startswith("Training over mesh {'data': 1, 'model': 2}:") for m in messages)
    assert not ranks_1x2[1]["train"]["logs"] or all(
        "Training over mesh" not in m for m in ranks_1x2[1]["train"]["logs"])
