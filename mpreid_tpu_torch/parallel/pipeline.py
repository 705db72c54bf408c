"""GPipe pipeline parallelism for the transformer towers.

ref mpreid_tpu/parallel/pipeline.py::pipe_mesh, ::stack_block_params,
::unstack_block_params, ::gpipe_apply, ::pipelined_blocks.

Contiguous groups of a tower's residual blocks ("stages") live on the ranks
of a pipe group, and microbatches stream through them:

* **stage-local parameters.** ``stack_block_params`` stacks the per-block
  tensors (``{prefix}{i}.{leaf}``) into leaves of shape ``(S, L/S, …)``;
  each rank takes only its stage's row (``stage_block_params``), and needs
  no other block's tensors;
* **fill-drain schedule.** With M microbatches and S stages the pipeline
  runs ``M + S − 1`` ticks; at tick ``t`` stage ``s`` computes microbatch
  ``t − s``. Stage 0 takes microbatch ``t`` of the input; the others receive
  their activation from the stage before, by point-to-point transfer (a
  CUDA tensor under gloo goes through host memory: gloo moves CPU tensors
  only, and NCCL refuses two ranks on one card). The last stage keeps the
  outputs, and a broadcast from it replicates the result over the pipe
  group, as the JAX package's ``psum`` over a zeros-elsewhere buffer does.
  The bubble is the standard ``(S − 1)/(M + S − 1)``;
* **gradients hop back in autograd.** The schedule is one
  ``torch.autograd.Function``: its backward drains the microbatches in
  reverse, the last stage from the output's cotangent (the same on every
  rank: the loss is replicated), each stage sending its input's cotangent
  to the stage before; the parameters' gradients stay on their stage and
  the input's, formed on stage 0, is broadcast to every rank of the group
  (the input is replicated). So the pipelined tower's gradients equal the
  sequential tower's (``tests/test_torch_pipeline.py``).
  ``remat=True`` keeps no stage activations between the passes and
  recomputes them in the backward (GPipe's memory form; same gradients).

The blocks of a stage are ordinary port modules, so each runs the attention
kernel (``ops/attention.py``) as any block does. A world of several pipe
groups (``pipe_mesh`` over consecutive blocks of S ranks) runs one pipeline
per group, each on its own inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.func import functional_call

from . import collectives as C
from .dist import rank as _rank
from .dist import world_size

_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32}


@dataclasses.dataclass(frozen=True)
class PipeMesh:
    """``stages`` ranks in a row: this rank's pipe group (``ranks``, global,
    stage by stage; ``group`` None for the default group)."""

    stages: int
    ranks: tuple
    group: Any = None

    @property
    def stage(self) -> int:
        return self.ranks.index(_rank())


_GROUPS: Dict[tuple, Any] = {}


def pipe_mesh(n_stages: int) -> PipeMesh:
    """This rank's pipe group of ``n_stages`` consecutive ranks: the world
    splits into ``world / n_stages`` groups, one pipeline each (every rank
    must call this, in the same order)."""
    n = world_size()
    if n_stages < 1 or n % n_stages:
        raise ValueError(f"{n_stages} stages do not split {n} ranks")
    first = _rank() // n_stages * n_stages
    ranks = tuple(range(first, first + n_stages))
    if n_stages == n or not dist.is_initialized():
        return PipeMesh(n_stages, ranks)
    key = (id(dist.group.WORLD), n_stages)
    if key not in _GROUPS:
        mine = None
        for lo in range(0, n, n_stages):
            g = dist.new_group(list(range(lo, lo + n_stages)))
            if lo == first:
                mine = g
        _GROUPS[key] = mine
    return PipeMesh(n_stages, ranks, _GROUPS[key])


def stack_block_params(params: Dict[str, torch.Tensor], n_layers: int, n_stages: int,
                       prefix: str = "resblocks.") -> Dict[str, torch.Tensor]:
    """``{prefix}{i}.{leaf}`` tensors → ``{leaf: (S, L/S, …)}``, stage-major
    (differentiable: ``torch.stack``). Requires ``n_layers % n_stages == 0``."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} blocks not divisible into {n_stages} stages")
    per = n_layers // n_stages
    leaves = [k[len(f"{prefix}0."):] for k in params if k.startswith(f"{prefix}0.")]
    return {leaf: torch.stack([params[f"{prefix}{i}.{leaf}"] for i in range(n_layers)])
            .reshape(n_stages, per, *params[f"{prefix}0.{leaf}"].shape) for leaf in leaves}


def unstack_block_params(stacked: Dict[str, torch.Tensor],
                         prefix: str = "resblocks.") -> Dict[str, torch.Tensor]:
    """Inverse of ``stack_block_params``."""
    first = next(iter(stacked.values()))
    s, per = first.shape[0], first.shape[1]
    return {f"{prefix}{i}.{leaf}": t[i // per, i % per]
            for i in range(s * per) for leaf, t in stacked.items()}


def stage_block_params(params: Dict[str, torch.Tensor], n_layers: int, pipe: PipeMesh,
                       prefix: str = "resblocks.") -> Dict[str, torch.Tensor]:
    """This stage's blocks of ``params`` stacked → ``{leaf: (L/S, …)}``;
    ``params`` needs only those blocks' tensors."""
    if n_layers % pipe.stages:
        raise ValueError(f"{n_layers} blocks not divisible into {pipe.stages} stages")
    per = n_layers // pipe.stages
    lo = pipe.stage * per
    local = {f"{prefix}{i - lo}.{k[len(f'{prefix}{i}.'):]}": v
             for i in range(lo, lo + per) for k, v in params.items()
             if k.startswith(f"{prefix}{i}.")}
    return {leaf: t[0] for leaf, t in stack_block_params(local, per, 1, prefix).items()}


def _send(t: torch.Tensor, stage: int, pipe: PipeMesh) -> None:
    dst = pipe.ranks[stage]
    if t.is_cuda and dist.get_backend(pipe.group) == "gloo":
        t = t.cpu()  # gloo transfers host tensors only
    t = t.to(_WIDEN.get(t.dtype, t.dtype)).contiguous()
    dist.send(t, dst, group=pipe.group)


def _recv(like: torch.Tensor, stage: int, pipe: PipeMesh) -> torch.Tensor:
    src = pipe.ranks[stage]
    staged = like.is_cuda and dist.get_backend(pipe.group) == "gloo"
    buf = torch.empty(like.shape, dtype=_WIDEN.get(like.dtype, like.dtype),
                      device="cpu" if staged else like.device)
    dist.recv(buf, src, group=pipe.group)
    return buf.to(device=like.device, dtype=like.dtype)


def _stage_fn(block_apply: Callable, names: Sequence[str], per: int) -> Callable:
    def run(leaves: List[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
        for j in range(per):
            h = block_apply({n: t[j] for n, t in zip(names, leaves)}, h)
        return h
    return run


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, pipe, m, remat, x, *leaves):
        s, n_stages = pipe.stage, pipe.stages
        xs = x.reshape(m, x.shape[0] // m, *x.shape[1:])
        ctx.run, ctx.pipe, ctx.m, ctx.remat = run, pipe, m, remat
        ctx.saved_leaves = leaves if remat else None
        ctx.saved = [None] * m  # per microbatch: (input, output, parameter leaves) or input
        outs = torch.zeros_like(xs) if s == n_stages - 1 else None
        for t in range(m + n_stages - 1):
            i = t - s
            if not 0 <= i < m:
                continue
            h_in = xs[i] if s == 0 else _recv(xs[i], s - 1, pipe)
            if remat:
                h_out = run(list(leaves), h_in)
                ctx.saved[i] = h_in
            else:
                with torch.enable_grad():
                    h_leaf = h_in.detach().requires_grad_(True)
                    p_leaves = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
                    h_out = run(p_leaves, h_leaf)
                ctx.saved[i] = (h_leaf, h_out, p_leaves)
            if s < n_stages - 1:
                _send(h_out.detach(), s + 1, pipe)
            else:
                outs[i] = h_out.detach()
        if outs is None:
            outs = torch.zeros_like(xs)
        C.broadcast(outs, pipe.ranks[-1], pipe.group)
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        pipe, m, s = ctx.pipe, ctx.m, ctx.pipe.stage
        n_stages = pipe.stages
        gs = grad.reshape(m, grad.shape[0] // m, *grad.shape[1:])
        need_x = ctx.needs_input_grad[4]
        leaf_grads = None
        dx = torch.zeros_like(gs)
        for i in reversed(range(m)):
            g_out = gs[i] if s == n_stages - 1 else _recv(gs[i], s + 1, pipe)
            if ctx.remat:
                with torch.enable_grad():
                    h_leaf = ctx.saved[i].detach().requires_grad_(True)
                    p_leaves = [p.detach().requires_grad_(p.requires_grad)
                                for p in ctx.saved_leaves]
                    h_out = ctx.run(p_leaves, h_leaf)
            else:
                h_leaf, h_out, p_leaves = ctx.saved[i]
            wrt = [h_leaf] + [p for p in p_leaves if p.requires_grad]
            grads = torch.autograd.grad(h_out, wrt, g_out, allow_unused=True,
                                        materialize_grads=True)
            dh, dp = grads[0], list(grads[1:])
            leaf_grads = dp if leaf_grads is None else [a + b for a, b in zip(leaf_grads, dp)]
            if s > 0:
                _send(dh, s - 1, pipe)
            else:
                dx[i] = dh
            ctx.saved[i] = None
        if need_x:
            C.broadcast(dx, pipe.ranks[0], pipe.group)
        it = iter(leaf_grads or [])
        out = [next(it) if need else None for need in ctx.needs_input_grad[5:]]
        return (None, None, None, None, dx.reshape(grad.shape) if need_x else None, *out)


def gpipe_apply(block_apply: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
                stage_params: Dict[str, torch.Tensor], x: torch.Tensor, pipe: PipeMesh,
                microbatches: Optional[int] = None, remat: bool = False) -> torch.Tensor:
    """Apply ``S × L/S`` blocks to ``x`` (batch-leading, the same on every
    rank of the pipe group) under GPipe → the result on every rank.

    ``block_apply(block_params, h) -> h`` is one block on one microbatch;
    ``stage_params`` is this rank's stage, ``{leaf: (L/S, …)}``
    (``stage_block_params``). Equal to applying the blocks one after the
    other: microbatching is exact for per-sample block math (LayerNorm and
    attention never mix samples). ``microbatches`` defaults to
    ``min(B, 2·S)``, as in the JAX package."""
    b = x.shape[0]
    m = microbatches if microbatches is not None else min(b, 2 * pipe.stages)
    if b % m:
        raise ValueError(f"batch {b} not divisible into {m} microbatches")
    names = list(stage_params)
    per = stage_params[names[0]].shape[0]
    run = _stage_fn(block_apply, names, per)
    return _GPipe.apply(run, pipe, m, remat, x, *[stage_params[n] for n in names])


def pipelined_blocks(block_module: torch.nn.Module, params: Dict[str, torch.Tensor],
                     n_layers: int, x: torch.Tensor, pipe: PipeMesh,
                     microbatches: Optional[int] = None,
                     mask: Optional[torch.Tensor] = None,
                     prefix: str = "resblocks.", remat: bool = False) -> torch.Tensor:
    """Run a tower's ``{prefix}{i}`` blocks under GPipe: ``block_module`` is
    one block (e.g. ``models.layers.ResidualAttentionBlock``) whose forward
    is applied with each block's tensors in turn (``functional_call``);
    ``params`` holds at least this stage's blocks' tensors (a tower's
    ``transformer.state_dict()``, or its named parameters); ``mask`` is the
    blocks' additive attention mask."""
    stage = stage_block_params(params, n_layers, pipe, prefix)

    def apply_one(p, h):
        return functional_call(block_module, p, (h, mask))

    return gpipe_apply(apply_one, stage, x, pipe, microbatches=microbatches, remat=remat)
