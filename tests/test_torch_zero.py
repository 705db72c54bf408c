"""ZeRO-1 in the port (mpreid_tpu_torch.parallel.zero) against replicated data parallelism.

ref tests/test_zero.py. Two gloo ranks on the CPU (one job for the module,
``parallel.launch.spawn``) train the tiny ViT baseline through the
data-parallel ``make_train_step`` from one state and generator, once with
the replicated optimizer and once under ``zero_sharded``. The JAX package's
claim is bitwise, and so is the port's (``torch.equal``):

* parameters and moments (gathered to the parameters' shapes) after 3
  steps, for SGD, Adam and AdamW, fp32 and bf16 moments;
* the fused-Adam route is decided by the whole leaf's size: with the route
  rule run as on the card (no card here), a leaf of exactly
  ``MIN_FUSED_SIZE`` elements sends each rank's half to the kernel (a spy
  standing in for it) and a leaf one element smaller takes the plain path,
  both as the replicated update does;
* a checkpoint written after 3 steps holds the moments gathered (the
  replicated run's, bit for bit) and, restored under ZeRO, continues 2
  steps bitwise with the uninterrupted run;
* each rank holds about half the replicated optimizer state.

This module imports nothing of JAX at its top: the spawned ranks import it
to find their function.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.config import get_default_cfg
from mpreid_tpu_torch.engine import initial_state, make_train_step
from mpreid_tpu_torch.engine.processor import checkpoint_state
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import VIT_B16, ReIDModel
from mpreid_tpu_torch.ops.adam import MIN_FUSED_SIZE
from mpreid_tpu_torch.parallel import make_mesh, shard_batch, zero_sharded
from mpreid_tpu_torch.parallel.launch import spawn
from mpreid_tpu_torch.parallel.zero import ZeroOptimizer, optimizer_state_bytes
from mpreid_tpu_torch.solver import make_optimizer
from mpreid_tpu_torch.solver import optim as toptim
from mpreid_tpu_torch.utils.checkpoint import load_checkpoint, restore_state, save_checkpoint

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

WORLD, BATCH, NC, LR = 2, 16, 8, 1e-3
CLIP = dataclasses.replace(VIT_B16, embed_dim=32, vision_layers=2, vision_width=64,
                           h_resolution=2, w_resolution=1, transformer_width=64,
                           transformer_heads=1, transformer_layers=2)
COMBOS = [(name, md) for name in ("SGD", "Adam", "AdamW") for md in ("float32", "bfloat16")]


def _cfg(name="Adam", moment_dtype="float32", augment=True):
    cfg = get_default_cfg()
    cfg.MODEL.DEVICE, cfg.MODEL.NAME = "cpu", "ViT-B-16"
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.INPUT.SIZE_TRAIN = [32, 16]
    cfg.SOLVER.OPTIMIZER_NAME, cfg.SOLVER.MOMENT_DTYPE = name, moment_dtype
    cfg.SOLVER.WEIGHT_DECAY = cfg.SOLVER.WEIGHT_DECAY_BIAS = 1e-4
    cfg.SOLVER.BIAS_LR_FACTOR = 2
    if not augment:
        cfg.INPUT.PROB, cfg.INPUT.PADDING, cfg.INPUT.RE_PROB = 0.0, 0, 0.0
    return cfg


def _batches(n):
    rng = np.random.default_rng(3)
    return [{"images": rng.integers(0, 256, (BATCH, 32, 16, 3), dtype=np.uint8),
             "pids": rng.permutation(np.repeat(np.arange(BATCH // 4), 4)).astype(np.int32),
             "camids": np.zeros(BATCH, np.int32), "trackids": np.zeros(BATCH, np.int32)}
            for _ in range(n)]


def _train(cfg, weights, mesh, zero: bool, steps, state_from=None, first=0):
    """``steps`` data-parallel steps from ``weights`` (or from a checkpoint
    payload, restored) → (model, optimizer, state)."""
    model = ReIDModel(CLIP, NC, camera_num=14, view_num=1)
    model.load_state_dict(weights)
    opt = make_optimizer(cfg.SOLVER, model, stage="baseline")
    if zero:
        opt = zero_sharded(opt, mesh, model)
    state = initial_state(model, opt)
    if state_from is not None:
        restore_state(state, state_from, opt)
    step = make_train_step(model, cfg, make_loss(cfg, NC)[0], opt, mesh=mesh)
    gen = torch.Generator().manual_seed(11)
    for batch in _batches(first + steps)[first:]:
        state, _ = step(state, shard_batch(batch, mesh), LR, gen)
    return model, opt, state


def _snapshot(model, opt, state):
    full = checkpoint_state(state, opt).opt_state
    return {"params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "mu": {k: v.clone() for k, v in full.mu.items()},
            "nu": {k: v.clone() for k, v in full.nu.items()},
            "bytes": optimizer_state_bytes(state.opt_state)}


def _route_check(mesh, zero: bool):
    """One fused-Adam update of three leaves (MIN_FUSED_SIZE, one less, 5
    elements) with the route rule as on the card → (the sizes the rule saw,
    the sizes the kernel got, the parameters after)."""
    module = torch.nn.Module()
    gen = torch.Generator().manual_seed(2)
    for name, n in (("big", MIN_FUSED_SIZE), ("odd", MIN_FUSED_SIZE - 1), ("small", 5)):
        module.register_parameter(name, torch.nn.Parameter(torch.randn(n, generator=gen)))
    cfg = _cfg()
    cfg.SOLVER.FUSED_ADAM = True
    opt = toptim.Optimizer("Adam", module, cfg.SOLVER, stage="baseline")
    if zero:
        opt = zero_sharded(opt, mesh, module)
    seen, launched = [], []
    real_plain = toptim.adam_leaf_plain

    def route(p):
        seen.append(p.numel())
        return opt.fused_adam and p.numel() >= MIN_FUSED_SIZE

    def kernel(p, *args):  # the kernel's stand-in: its plain version
        launched.append(p.numel())
        return real_plain(p, *args)

    opt.kernel_route = route
    toptim.fused_adam_leaf, saved = kernel, toptim.fused_adam_leaf
    try:
        train, _ = opt.partition(module)
        grads = {k: torch.randn(p.shape, generator=gen) for k, p in train.items()}
        opt.update(grads, opt.init(module), train, LR)
    finally:
        toptim.fused_adam_leaf = saved
    return seen, launched, {k: p.detach().clone() for k, p in module.named_parameters()}


def _zero_job(weights, directory):
    mesh = make_mesh()
    out = {"combos": {}}
    for name, md in COMBOS:
        cfg = _cfg(name, md)
        out["combos"][(name, md)] = [_snapshot(*_train(cfg, weights, mesh, zero, 3))
                                     for zero in (False, True)]
    out["route"] = [_route_check(mesh, zero) for zero in (False, True)]
    # checkpoint: 3 steps, written by rank 0, restored, 2 more
    cfg = _cfg("Adam", "bfloat16", augment=False)
    model, opt, state = _train(cfg, weights, mesh, True, 3)
    saved = checkpoint_state(state, opt)
    path = os.path.join(directory, "zero.pth")
    if mesh.rank == 0:
        save_checkpoint(path, saved, 3)
    torch.distributed.barrier()
    payload = load_checkpoint(path)
    out["file_moments"] = payload["opt_state"]
    out["resumed"] = _snapshot(*_train(cfg, weights, mesh, True, 2, payload, first=3))
    out["uninterrupted"] = _snapshot(*_train(cfg, weights, mesh, True, 5))
    out["replicated_3"] = _snapshot(*_train(cfg, weights, mesh, False, 3))
    out["zero_keys"] = sorted(opt.zero_keys)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    model = ReIDModel(CLIP, NC, camera_num=14, view_num=1)
    model.init_(torch.Generator().manual_seed(0))
    return spawn(_zero_job, WORLD, (model.state_dict(), str(tmp_path_factory.mktemp("zero"))),
                 timeout=240, threads=2)


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("name,moment_dtype", COMBOS)
def test_zero_equals_replicated_dp_bitwise(ranks, name, moment_dtype):
    for out in ranks:
        replicated, zero = out["combos"][(name, moment_dtype)]
        _assert_equal(zero["params"], replicated["params"])
        _assert_equal(zero["mu"], replicated["mu"])
        _assert_equal(zero["nu"], replicated["nu"])
    _assert_equal(ranks[0]["combos"][(name, moment_dtype)][1]["params"],
                  ranks[1]["combos"][(name, moment_dtype)][1]["params"])


def test_zero_holds_about_half_the_moments_a_rank(ranks):
    for out in ranks:
        replicated, zero = out["combos"][("Adam", "float32")]
        assert 0.4 * replicated["bytes"] < zero["bytes"] < 0.6 * replicated["bytes"]
        assert zero["bytes"] * 2 < out["combos"][("Adam", "bfloat16")][0]["bytes"] * 2.5


def test_zero_keys_leave_the_classifiers_whole(ranks):
    keys = ranks[0]["zero_keys"]
    assert "image_encoder.transformer.resblocks.0.attn.in_proj_weight" in keys
    assert not any(k.startswith("classifier") for k in keys)
    assert "bottleneck.bias" not in keys  # never trained


def test_the_kernel_route_is_decided_by_the_whole_leaf(ranks):
    for r, out in enumerate(ranks):
        (seen_rep, launched_rep, p_rep), (seen_zero, launched_zero, p_zero) = out["route"]
        full = [MIN_FUSED_SIZE, MIN_FUSED_SIZE - 1, 5]
        assert seen_rep == full and seen_zero == full
        assert launched_rep == [MIN_FUSED_SIZE]
        assert launched_zero == [MIN_FUSED_SIZE // WORLD]  # this rank's half of the big leaf
        _assert_equal(p_zero, p_rep)


def test_checkpoint_holds_gathered_moments_and_resumes_bitwise(ranks):
    for out in ranks:
        file = out["file_moments"]
        assert file["step"] == 3
        _assert_equal(file["mu"], out["replicated_3"]["mu"])
        _assert_equal(file["nu"], out["replicated_3"]["nu"])
        _assert_equal(out["resumed"]["params"], out["uninterrupted"]["params"])
        _assert_equal(out["resumed"]["mu"], out["uninterrupted"]["mu"])


def test_zero_sharded_takes_the_base_optimizer_settings():
    model = ReIDModel(CLIP, NC, camera_num=14, view_num=1)
    cfg = _cfg("AdamW", "bfloat16")
    base = make_optimizer(cfg.SOLVER, model, stage="baseline")
    zero = zero_sharded(base, make_mesh(world=1), model)
    assert isinstance(zero, ZeroOptimizer) and zero.name == "AdamW"
    assert zero.moment_dtype == torch.bfloat16 and zero.lr_mult == base.lr_mult
    state = zero.init(model)  # one rank: every slice is the whole leaf, padded
    for k, p in model.named_parameters():
        if k in zero.zero_keys:
            assert state.mu[k].dim() == 1 and state.mu[k].numel() >= p.numel()
