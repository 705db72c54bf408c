"""The collectives of the mesh over ``torch.distributed``.

In the JAX package GSPMD inserts them (``psum``, ``all_gather`` over the
mesh's axes); the port calls them where its steps and layers need them.
The data axis:

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

The model axis (``mesh.ModelAxis``), the Megatron pair (Shoeybi et al.
2019) and a gather:

* ``copy_to_model``: identity forward; the backward sums the cotangent over
  the model group. It stands before every layer that computes a part from a
  replicated input (a column-parallel projection, the local experts, a
  class-sharded classifier), whose cotangent each rank holds only its part of;
* ``reduce_from_model``: the forward sums the ranks' partial results over
  the model group (a row-parallel projection's fp32 partial products, the
  local experts' mix); the backward is the identity, the cotangent of the
  replicated sum being the same on every rank;
* ``gather_columns``: the ranks' column blocks of one row (class-sharded
  logits, blocks of unequal width) side by side, no gradient (the training
  loop's accuracy, a global argmax).

Every rank of a model group computes the same replicated loss, so a
replicated parameter's gradient comes out whole, and equal, on each of them.

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

from typing import Dict, Mapping, Sequence

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


# ---------------------------------------------------------------------------
# the model axis
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def copy_to_model(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``axis``'s ranks (a
    ``mesh.ModelAxis``; None or one rank: nothing to do)."""
    if axis is None or axis.size == 1 or not _wants_grad(t):
        return t
    return _CopyToModel.apply(t, axis.group)


def reduce_from_model(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over ``axis``'s ranks; the gradient passes through."""
    if axis is None or axis.size == 1:
        return t
    if not _wants_grad(t):
        return all_reduce_sum(t.contiguous().clone(), axis.group)
    return _ReduceFromModel.apply(t, axis.group)


def gather_columns(t: torch.Tensor, sizes: Sequence[int], index: int, group=None
                   ) -> torch.Tensor:
    """The ranks' blocks of the last axis, of widths ``sizes`` (this rank's
    is block ``index``), side by side → (..., sum(sizes)), no gradient:
    each rank writes its block into a zero-filled whole and the wholes are
    summed (exact; gloo's form for CUDA tensors as well)."""
    t = t.detach()
    lo = sum(sizes[:index])
    full = torch.zeros((*t.shape[:-1], sum(sizes)), dtype=t.dtype, device=t.device)
    full[..., lo:lo + t.shape[-1]] = t
    return all_reduce_sum(full, group)
