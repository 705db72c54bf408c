"""The collectives of the data axis over ``torch.distributed``.

In the JAX package GSPMD inserts them (``psum``, ``all_gather`` over the
mesh's ``data`` axis); the port calls them where the data-parallel step
needs them:

* ``all_reduce_sum`` and ``broadcast``, in place;
* ``all_gather``: ranks' equal blocks concatenated along axis 0, no
  gradient;
* ``all_gather_cat``: the same, differentiable. Every rank computes the one
  global loss from the gathered tensor, so the cotangent that reaches it is
  the same on every rank, and its backward returns this rank's rows of it
  (no sum: the parameter gradients are summed once, after the backward);
* ``all_reduce_buckets``: a dict of tensors summed over the ranks through
  a few flat buffers (the gradients of the data-parallel step: one
  collective per ``BUCKET_ELEMS`` elements, not one per leaf);
* ``sum_over_ranks``: a differentiable all-reduce of per-rank partial sums
  that enter that replicated loss; its backward passes the cotangent
  through unchanged for the same reason.

gloo reduces and broadcasts CUDA tensors but does not gather them (the
``torch.distributed`` backend table: all_gather is CPU-only under gloo), so
for a CUDA tensor under gloo (two ranks sharing one card) ``all_gather`` is
written through ``all_reduce``: each rank writes its block at its offset
into a zero-filled (world·n, …) buffer and the buffers are summed. Adding
zeros is exact, so the result is the gather's bit for bit (−0.0 comes back
as +0.0, which compares equal). Every other backend and device takes the
native collective. 16-bit floats travel as fp32 (exact both ways, and gloo
reduces no 16-bit type everywhere) and bools as uint8.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist

ALIGN = 8  # elements: every leaf of a bucket starts 32 bytes (fp32) aligned
BUCKET_ELEMS = 1 << 25  # 128 MiB of fp32 a bucket
_WIDEN = {torch.bfloat16: torch.float32, torch.float16: torch.float32, torch.bool: torch.uint8}


def world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def gathers_through_all_reduce(t: torch.Tensor, group=None) -> bool:
    """True where ``all_gather`` of ``t`` goes through ``all_reduce``: a CUDA
    tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place → ``t``."""
    if world(group) > 1:
        wide = _WIDEN.get(t.dtype)
        if wide is None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        else:
            w = t.to(wide)
            dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
            t.copy_(w.to(t.dtype))
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place → ``t``."""
    if world(group) > 1:
        wide = _WIDEN.get(t.dtype)
        if wide is None:
            dist.broadcast(t, src=src, group=group)
        else:
            w = t.to(wide)
            dist.broadcast(w, src=src, group=group)
            t.copy_(w.to(t.dtype))
    return t


def gather_by_all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather`` written as a sum of zero-filled buffers (gloo's form
    for CUDA tensors; exact, see the module docstring)."""
    n, r = t.shape[0], _rank(group)
    dtype = _WIDEN.get(t.dtype, t.dtype)
    buf = torch.zeros((world(group) * n, *t.shape[1:]), dtype=dtype, device=t.device)
    buf[r * n:(r + 1) * n] = t.to(dtype)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal-sized ``t`` concatenated along axis 0, rank by rank
    (no gradient)."""
    if world(group) == 1:
        return t
    t = t.detach().contiguous()
    if gathers_through_all_reduce(t, group):
        return gather_by_all_reduce(t, group)
    out = torch.empty((world(group) * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    # all_gather_single is the newer name of all_gather_into_tensor
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, t, group=group)
    return out


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.rows, ctx.rank, ctx.group = t.shape[0], _rank(group), group
        return all_gather(t, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """``all_gather`` with a gradient: the backward returns this rank's rows
    of the cotangent (see the module docstring)."""
    if world(group) == 1:
        return t
    return _AllGatherCat.apply(t, group)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.detach().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over the ranks of per-rank partial sums of a
    replicated loss: the backward is the identity (see the module docstring)."""
    if world(group) == 1:
        return t
    return _SumOverRanks.apply(t, group)


def all_reduce_buckets(tensors: Mapping[str, torch.Tensor], group=None,
                       bucket_elems: int = BUCKET_ELEMS) -> Dict[str, torch.Tensor]:
    """``{name: tensor summed over the ranks}``, summed through flat buffers
    of at most ``bucket_elems`` elements (a larger tensor gets one of its
    own), consecutive tensors of one dtype and device sharing one. The
    results are views into the buffers, each starting at a multiple of
    ``ALIGN`` elements."""
    if world(group) == 1:
        return dict(tensors)
    keys, out, i = list(tensors), {}, 0
    while i < len(keys):
        first = tensors[keys[i]]
        chunk, size = [], 0
        while i < len(keys):
            t = tensors[keys[i]]
            n = -(-t.numel() // ALIGN) * ALIGN
            if (t.dtype, t.device) != (first.dtype, first.device) or \
                    chunk and size + n > bucket_elems:
                break
            chunk.append((keys[i], size))
            size += n
            i += 1
        buf = torch.zeros(size, dtype=first.dtype, device=first.device)
        for k, off in chunk:
            buf[off:off + tensors[k].numel()] = tensors[k].reshape(-1)
        all_reduce_sum(buf, group)
        for k, off in chunk:
            out[k] = buf[off:off + tensors[k].numel()].view(tensors[k].shape)
    return out
