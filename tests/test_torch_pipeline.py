"""The port's GPipe schedule (mpreid_tpu_torch.parallel.pipeline) against sequential application.

One job of two gloo ranks on the CPU (``parallel.launch.spawn``) runs every
case: S ∈ {1, 2} stages (two pipelines of one stage, or one of two), M ∈ {1,
4} microbatches, with and without the causal mask, and the
recomputing form (``remat``). Forward, input gradient and every block
parameter's gradient (the stage's, summed over the pipe group) must equal
the blocks applied one after the other in one process, to 2e-6 as
``__graft_entry__.py`` holds the JAX package's pipeline; the same blocks'
weights from a JAX text tower (``from_jax_variables``) give the JAX
package's ``pipelined_blocks`` output on its CPU mesh to 1e-5. Shapes the
schedule cannot split raise.

This module imports nothing of JAX at its top: the spawned ranks import it
to find their function.
"""

import numpy as np
import pytest
import torch

from mpreid_tpu_torch.models.layers import ResidualAttentionBlock
from mpreid_tpu_torch.models.text import causal_mask
from mpreid_tpu_torch.parallel.launch import spawn
from mpreid_tpu_torch.parallel.pipeline import (
    PipeMesh, gpipe_apply, pipe_mesh, pipelined_blocks, stack_block_params, stage_block_params,
    unstack_block_params,
)

from cpu_threads import one_thread  # noqa: F401  (autouse fixture)

WIDTH, HEADS, LAYERS, BATCH, LENGTH = 64, 2, 4, 8, 6
TOL = 2e-6
CASES = [(s, m, masked, False) for s in (1, 2) for m in (1, 4) for masked in (False, True)] \
    + [(2, 4, True, True)]


def _blocks(seed=0):
    gen = torch.Generator().manual_seed(seed)
    blocks = torch.nn.ModuleList(ResidualAttentionBlock(WIDTH, HEADS) for _ in range(LAYERS))
    for b in blocks:
        b.init_(gen)
    with torch.no_grad():  # non-zero biases and LayerNorms
        for p in blocks.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return blocks


def _inputs():
    gen = torch.Generator().manual_seed(1)
    return (torch.randn(BATCH, LENGTH, WIDTH, generator=gen),
            torch.randn(BATCH, LENGTH, WIDTH, generator=gen))


def _params(blocks):
    return {f"resblocks.{i}.{k}": p for i, b in enumerate(blocks) for k, p in b.named_parameters()}


def _sequential(masked):
    blocks = _blocks()
    x, w = _inputs()
    x.requires_grad_(True)
    mask = causal_mask(LENGTH) if masked else None
    h = x
    for b in blocks:
        h = b(h, mask)
    (h * w).sum().backward()
    return h.detach(), x.grad, {k: p.grad for k, p in _params(blocks).items()}


def _pipelined(stages, micro, masked, remat):
    import torch.distributed as dist

    blocks = _blocks()
    x, w = _inputs()
    x.requires_grad_(True)
    pipe = pipe_mesh(stages)
    params = _params(blocks)
    y = pipelined_blocks(blocks[0], params, LAYERS, x, pipe, microbatches=micro,
                         mask=causal_mask(LENGTH) if masked else None, remat=remat)
    (y * w).sum().backward()
    grads = {}
    for k, p in params.items():  # the stage's own; summed over the pipe group
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if stages > 1:
            dist.all_reduce(g, group=pipe.group)
        grads[k] = g
    return y.detach(), x.grad, grads


def _job(cases):
    out = {case: _pipelined(*case) for case in cases}
    errors = {}
    pipe = pipe_mesh(2)
    try:
        gpipe_apply(lambda p, h: h, {"w": torch.zeros(1, 1)}, torch.zeros(6, 2), pipe,
                    microbatches=4)
    except ValueError as e:
        errors["microbatches"] = str(e)
    try:
        pipelined_blocks(_blocks()[0], _params(_blocks()), 3, torch.zeros(4, 2, WIDTH), pipe)
    except ValueError as e:
        errors["stages"] = str(e)
    try:
        pipe_mesh(3)
    except ValueError as e:
        errors["ranks"] = str(e)
    out["errors"] = errors
    out["pipes"] = (pipe.stage, pipe.ranks, pipe_mesh(1).ranks)
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_job, 2, (CASES,), timeout=120, threads=2)


def _rel(a, b, floor=0.0):
    return float((a - b).norm() / max(float(b.norm()), floor, 1e-30))


@pytest.mark.parametrize("stages,micro,masked,remat", CASES)
def test_gpipe_equals_sequential_application(ranks, stages, micro, masked, remat):
    y, dx, grads = _sequential(masked)
    floor = 1e-2 * max(float(g.norm()) for g in grads.values())
    for out in ranks:
        got_y, got_dx, got_grads = out[(stages, micro, masked, remat)]
        np.testing.assert_allclose(got_y.numpy(), y.numpy(), rtol=TOL, atol=TOL)
        assert _rel(got_dx, dx) <= TOL
        assert set(got_grads) == set(grads)
        for k, g in grads.items():
            assert _rel(got_grads[k], g, floor) <= TOL, k


def test_shapes_the_schedule_cannot_split_raise(ranks):
    for out in ranks:
        errors = out["errors"]
        assert "batch 6 not divisible into 4 microbatches" in errors["microbatches"]
        assert "3 blocks not divisible into 2 stages" in errors["stages"]
        assert "3 stages do not split 2 ranks" in errors["ranks"]
    assert [out["pipes"] for out in ranks] == [(0, (0, 1), (0,)), (1, (0, 1), (1,))]


def test_stacking_round_trips_and_takes_the_stage():
    params = {k: p.detach() for k, p in _params(_blocks()).items()}
    stacked = stack_block_params(params, LAYERS, 2)
    leaf = "attn.in_proj_weight"
    assert stacked[leaf].shape == (2, LAYERS // 2, 3 * WIDTH, WIDTH)
    back = unstack_block_params(stacked)
    assert set(back) == set(params) and all(torch.equal(back[k], v) for k, v in params.items())
    stage1 = stage_block_params({k: v for k, v in params.items()
                                 if k.split(".")[1] in ("2", "3")}, LAYERS, PipeMesh(2, (5, 0)))
    assert torch.equal(stage1[leaf], stacked[leaf][1])
    with pytest.raises(ValueError, match="not divisible into 3 stages"):
        stack_block_params(params, LAYERS, 3)


def test_gpipe_equals_the_jax_pipeline(ranks):
    """The JAX package's 2-stage ``pipelined_blocks`` on its CPU mesh and the
    port's (a 1-stage pipe here: two stages ran in the job above) from the
    same text-block weights."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mpreid_tpu.models.factory import init_variables
    from mpreid_tpu.models.layers import ResidualAttentionBlock as JaxBlock
    from mpreid_tpu.models.uniprompt import UniPromptReID as JaxUni
    from mpreid_tpu.parallel.pipeline import pipe_mesh as jax_pipe_mesh
    from mpreid_tpu.parallel.pipeline import pipelined_blocks as jax_pipelined_blocks
    from mpreid_tpu_torch.models import CLIPConfig, UniPromptReID, from_jax_variables
    from test_torch_moe import _seeded
    from tiny import tiny_cfg, tiny_clip_config

    clip = tiny_clip_config(transformer_width=WIDTH, transformer_heads=HEADS,
                            transformer_layers=LAYERS, text_layout="packed")
    jmodel = JaxUni(clip_config=clip, num_classes=4, camera_num=14, view_num=1)
    variables = _seeded(init_variables(jmodel, jax.random.PRNGKey(0), tiny_cfg(), abstract=True),
                        2)
    x = np.random.default_rng(3).standard_normal((BATCH, LENGTH, WIDTH)).astype(np.float32)
    mask = jnp.triu(jnp.full((LENGTH, LENGTH), -jnp.inf, jnp.float32), k=1)
    blk = JaxBlock(WIDTH, HEADS, layout="packed")
    want = np.asarray(jax_pipelined_blocks(blk, jax.tree_util.tree_map(np.asarray,
                                                                       variables["params"]["text"]),
                                           LAYERS, jnp.asarray(x), jax_pipe_mesh(2),
                                           microbatches=4, mask=mask))
    tclip = CLIPConfig(**dataclasses.asdict(clip))
    model = UniPromptReID(tclip, 4, camera_num=14, view_num=1)
    model.load_state_dict(from_jax_variables(variables, tclip), strict=True)
    tower = model.text_encoder.transformer
    got = pipelined_blocks(tower.resblocks[0], dict(tower.named_parameters()), LAYERS,
                           torch.from_numpy(x), PipeMesh(1, (0,)), microbatches=4,
                           mask=causal_mask(LENGTH))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
