"""The port's MoE image tower and stage 2b against the benchmark's plain
reference (``portbench/reference/moe.py``), which imports nothing of the
port or of JAX.

The model is the ``vitb16-moe`` configuration at ``MODEL.DEBUG_TINY`` (two
64-wide blocks, one head) on 64 × 32 images, in fp32 on the CPU, with the
benchmark's seeded weights (``portbench/data/weights.py``): non-zero gates
and four distinct experts, top-2, so the routing decides the output.
Tolerances, fp32: forwards and losses to 1e-5 (the two sum in other
orders), the routing's experts equal; gradients per leaf to a norm-relative
1e-4, the reference norm floored at 1e-3 of the largest leaf's
(tests/test_torch_moe.py).
"""

import copy

import numpy as np
import pytest
import torch

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)
from mpreid_tpu_torch.engine.steps import loss_and_grads
from mpreid_tpu_torch.engine.uniprompt import precompute_text_features
from mpreid_tpu_torch.losses import make_loss
from mpreid_tpu_torch.models import moe
from mpreid_tpu_torch.ops.augment import eval_preprocess
from mpreid_tpu_torch.solver import make_optimizer
from portbench.data import weights
from portbench.harness import manifest, port, runner
from portbench.reference import moe as ref_moe
from portbench.reference import train as ref_train
from portbench.reference.precision import Precision
from portbench.tests.conftest import TINY

CELL = "vitb16-moe.stage2b"
SEED = 2 ** 31 + 91
CLASSES = 8
FP32 = Precision("fp32")
PROGRAM = manifest.program("moe_train_epoch")


def _context(moe_layers=2, shared=True, seed=SEED):
    ov = copy.deepcopy(TINY)
    ov["cfg"]["MODEL"]["MOE"] = {"MOE_LAYERS": moe_layers, "SHARED_ROUTING": shared}
    ov["traffic"]["classes"] = CLASSES
    return runner.context(manifest.Cell(CELL), seed, "cpu", ov)


def _model(moe_layers=2, shared=True):
    """(context, the port's tiny MoE model, the reference's weights)."""
    ctx = _context(moe_layers, shared)
    model, shapes = port.build(ctx, True)
    W = PROGRAM.reference_names(weights.make(shapes, ctx.streams["weights"], "cpu"))
    return ctx, model, W


def _moe(ctx):
    return PROGRAM.Program(ctx).moe()


def _images(n=8, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, 64, 32, 3), dtype=np.uint8))


def _close(a, b, tol=1e-5):
    assert a.shape == b.shape
    assert float((a.detach().float() - b.detach().float()).abs().max()) < tol


def _sets(combine):
    """(N, E) combine weights → each token's experts, ascending."""
    return torch.stack([torch.nonzero(row).squeeze(1) for row in combine])


def test_the_seeded_experts_differ_and_the_gates_are_not_zero():
    _, model, W = _model()
    block = model.image_encoder.transformer.resblocks[0]
    assert isinstance(block, moe.MoEResidualAttentionBlock)
    assert float(block.gate.weight.detach().abs().min()) > 0
    stack = block.experts.c_fc_weight
    assert all(not torch.equal(stack[0], stack[m]) for m in range(1, stack.shape[0]))
    name = "image_encoder.transformer.resblocks.0.experts"
    for m in range(stack.shape[0]):
        assert torch.equal(W[f"{name}.{m}.c_fc.weight"], stack[m].detach())
        assert torch.equal(W[f"{name}.{m}.c_proj.bias"], block.experts.c_proj_bias[m].detach())


@pytest.mark.parametrize("given_routing", [False, True])
def test_moe_block_matches_the_reference(given_routing):
    """Block 0 routes itself; block 1 takes block 0's combine weights, as
    shared routing hands them on."""
    ctx, model, W = _model()
    top_k = ctx.cfg.MODEL.MOE.TOP_K
    blocks = model.image_encoder.transformer.resblocks
    x = torch.randn(4, 9, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, logits, combine = blocks[0](x)
        r_out, r_logits, (selected, w), _ = ref_moe.block(
            x, W, "image_encoder.transformer.resblocks.0", FP32, top_k)
        assert torch.equal(_sets(combine), selected.sort(dim=1).values)
        # not a trivial routing: every expert is somebody's choice
        assert set(selected.unique().tolist()) == set(range(4))
        if given_routing:
            out, logits, _ = blocks[1](out, routing=combine)
            r_out, r_logits, _, _ = ref_moe.block(
                r_out, W, "image_encoder.transformer.resblocks.1", FP32, top_k, (selected, w))
            assert logits is None and r_logits is None
        else:
            _close(logits, r_logits)
    _close(out, r_out)


def test_the_reference_takes_given_experts_with_its_own_weights():
    """``given`` experts (the port's, in the check) replace the block's own
    choice in its forward, weighted by its own probabilities; the block
    still reports its own choice, which ``route_gap`` compares."""
    ctx, _, W = _model()
    name, top_k = "image_encoder.transformer.resblocks.0", ctx.cfg.MODEL.MOE.TOP_K
    x = torch.randn(4, 9, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out, logits, (chosen, w), own = ref_moe.block(x, W, name, FP32, top_k)
        same = ref_moe.block(x, W, name, FP32, top_k, given=own.sort(dim=1).values)
        _close(same[0], out, 1e-6)
        other = (own + 1) % 4  # every token handed two experts it did not choose
        moved, _, (taken, tw), own2 = ref_moe.block(x, W, name, FP32, top_k, given=other)
    assert torch.equal(own, own2) and torch.equal(chosen, own) and torch.equal(taken, other)
    probs = torch.softmax(logits, dim=-1).gather(1, other)
    _close(tw, probs / probs.sum(dim=1, keepdim=True))
    assert float((moved - out).abs().max()) > 1e-3


@pytest.mark.parametrize("moe_layers, shared", [(2, True), (1, True), (2, False)])
def test_moe_tower_matches_the_reference(moe_layers, shared):
    ctx, model, W = _model(moe_layers, shared)
    x = eval_preprocess(_images(), mean=ctx.cfg.INPUT.PIXEL_MEAN, std=ctx.cfg.INPUT.PIXEL_STD)
    with torch.no_grad():
        x11, x12, xproj, router_logits = model.image_encoder(x)
        last, feat, proj, gating, first = ref_moe.vision(x, W, FP32, _moe(ctx))
    _close(x11[:, 0], last)
    _close(x12[:, 0], feat)
    _close(xproj[:, 0], proj)
    assert router_logits.shape[0] == len(gating) == (1 if shared else moe_layers)
    for a, b in zip(router_logits, gating):
        _close(a, b)
    _, port_first = moe.topk_routing(router_logits[0], ctx.cfg.MODEL.MOE.TOP_K)
    assert torch.equal(port_first.sort(dim=1).values, first.sort(dim=1).values)


def test_a_stage2b_step_matches_the_reference():
    """One stage-2b loss (the aux loss in it) and the gradient of every
    trained leaf: the experts train none, the routing gate gets one."""
    ctx, model, W = _model()
    cfg = ctx.cfg
    images = _images()
    labels = torch.arange(8) % 4
    loss_fn, _ = make_loss(cfg, CLASSES)
    opt = make_optimizer(cfg.SOLVER.STAGE2, model, stage="stage2b")
    text = precompute_text_features(cfg, model, CLASSES)
    x = eval_preprocess(images, mean=cfg.INPUT.PIXEL_MEAN, std=cfg.INPUT.PIXEL_STD)
    loss, _, grads, _ = loss_and_grads(model, cfg, loss_fn, opt, x, labels, text_features=text)

    config = copy.deepcopy(ctx.cell.config["cfg"])
    config["INPUT"].update(PROB=0.0, RE_PROB=0.0, PADDING=0)  # the reference's augmentation off
    r_text = ref_train.text_features(W, CLASSES, FP32)
    _close(text, r_text)
    r_loss_fn = ref_moe.stage2b_loss(config, CLASSES, r_text, FP32, _moe(ctx))
    train = {k: v.clone().requires_grad_(True) for k, v in W.items() if ref_moe.trains(k)}
    r_loss = r_loss_fn(dict(W, **train), images, labels, torch.Generator().manual_seed(0))
    r_grads = dict(zip(train, torch.autograd.grad(r_loss, list(train.values()),
                                                  allow_unused=True)))
    r_value = float(r_loss.detach())
    assert abs(float(loss) - r_value) < 1e-5 * abs(r_value)
    assert set(grads) == set(train)
    assert not any("experts" in k for k in grads)
    assert float(grads["image_encoder.transformer.resblocks.0.gate.weight"].norm()) > 0
    floor = 1e-3 * max(float(g.norm()) for g in r_grads.values() if g is not None)
    for k, g in grads.items():
        want = r_grads[k] if r_grads[k] is not None else torch.zeros_like(g)
        assert float((g - want).norm()) <= 1e-4 * max(float(want.norm()), floor), k


def test_the_expert_counters_on_one_forward():
    ctx, model, _ = _model()
    x = eval_preprocess(_images(), mean=ctx.cfg.INPUT.PIXEL_MEAN, std=ctx.cfg.INPUT.PIXEL_STD)
    c = moe.expert_layers
    before = (c.launches, c.rows)
    with torch.no_grad():
        model.image_encoder(x)
    tokens = 8 * 9  # 8 images of 4 x 2 patches and a class token
    assert (c.launches - before[0], c.rows - before[1]) == (2, tokens * 4 * 2)


def test_the_tiny_cell_runs_and_agrees_with_the_reference():
    """``vitb16-moe.stage2b`` through the benchmark's runner, with one MoE
    block so that a dense block follows, as the other cells run in
    portbench/tests/test_portbench_programs.py."""
    ov = copy.deepcopy(TINY)
    ov["cfg"]["MODEL"]["MOE"] = {"MOE_LAYERS": 1}
    cell = manifest.Cell(CELL)
    result = runner.execute(cell, 2 ** 31 + 77, 0.5, False, "cpu", ov)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(result["check"]) == list(cell.workload["limits"])
    for n in result["check"].values():
        assert n["value"] < 1e-3, result["check"]


def _frozen_gate(monkeypatch):
    """Stage 2b's partition without the gates."""
    from mpreid_tpu_torch.solver import optim

    trainable = optim.stage_trainable
    monkeypatch.setattr(optim, "stage_trainable", lambda params, stage: {
        k: v and ".gate." not in k for k, v in trainable(params, stage).items()})


def _detached_router(monkeypatch):
    """The routing weights cut from the router's logits: the gate then
    trains on the aux loss alone."""
    routing = moe.topk_routing
    monkeypatch.setattr(moe, "topk_routing", lambda logits, k: routing(logits.detach(), k))


@pytest.mark.parametrize("fault", [_frozen_gate, _detached_router])
def test_the_tiny_cell_sees_a_gate_that_does_not_train_as_stage_2b_trains_it(fault, monkeypatch):
    """A port whose stage 2b leaves the gates out, or trains them on the aux
    loss alone, comes out not correct: ``gate_delta_diff`` sees it where
    the numbers over every leaf do not."""
    fault(monkeypatch)
    ov = copy.deepcopy(TINY)
    ov["cfg"]["MODEL"]["MOE"] = {"MOE_LAYERS": 1}
    result = runner.execute(manifest.Cell(CELL), 2 ** 31 + 77, 0.5, False, "cpu", ov)
    gate = result["check"]["gate_delta_diff"]
    assert not result["correct"]
    assert gate["value"] > max(gate["limit"], 0.9), result["check"]
