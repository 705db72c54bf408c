"""Cross-entropy losses, and their class-parallel forms.

ref mpreid_tpu/losses/softmax.py::cross_entropy, ::cross_entropy_label_smooth.

Over a model axis the bias-free classifiers are split by class rows
(``parallel/mesh.py::shard_module``): each rank's logits are its columns,
and the caller passes the classifier's ``Split`` as ``split``
(``models/layers.py::class_split``). Both losses then take their
class-parallel form, where the JAX
package lets GSPMD partition the log-softmax: the row max, the sum of
exponentials, the target's logit (from the rank that owns the target) and,
for label smoothing, the sum of the logits are each reduced over the model
group, and every rank computes the same loss. The backward stays local:
softmax minus the (smoothed) one-hot on the rank's own columns, which the
classifier's ``copy_to_model`` turns into whole feature gradients.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class _ClassParallelCE(torch.autograd.Function):
    """Mean over the batch of the (label-smoothed) cross entropy of logits
    split by columns over the model axis (``split``: ``parallel.mesh.Split``)."""

    @staticmethod
    def forward(ctx, logits, targets, split, epsilon):
        # at call time: the parallel package imports the solver, which imports the losses
        from mpreid_tpu_torch.parallel import collectives as C

        axis = split.axis
        x = logits.float()
        b, n = x.shape
        total, lo = sum(split.sizes), split.offset
        # the global row max: every rank's row maxes side by side, then the max
        row_max = C.gather_columns(x.amax(dim=1, keepdim=True), [1] * axis.size, axis.index,
                                   axis.group).amax(dim=1, keepdim=True)
        sum_exp = C.all_reduce_sum(torch.exp(x - row_max).sum(dim=1), axis.group)
        lse = row_max[:, 0] + torch.log(sum_exp)
        local = targets.long() - lo
        mine = (local >= 0) & (local < n)
        picked = x.gather(1, local.clamp(0, n - 1)[:, None])[:, 0]
        target_logit = C.all_reduce_sum(torch.where(mine, picked, torch.zeros_like(picked)),
                                        axis.group)
        per_row = (1.0 - epsilon) * (lse - target_logit)
        if epsilon:
            sum_logits = C.all_reduce_sum(x.sum(dim=1), axis.group)
            per_row = per_row + (epsilon / total) * (total * lse - sum_logits)
        ctx.save_for_backward(x, lse, local, mine)
        ctx.epsilon, ctx.total, ctx.dtype = epsilon, total, logits.dtype
        return per_row.mean()

    @staticmethod
    def backward(ctx, grad):
        x, lse, local, mine = ctx.saved_tensors
        b = x.shape[0]
        target = torch.zeros_like(x)
        target[mine, local[mine]] = 1.0 - ctx.epsilon
        smoothed = target + ctx.epsilon / ctx.total
        dx = (torch.exp(x - lse[:, None]) - smoothed) * (grad / b)
        return dx.to(ctx.dtype), None, None, None


def _class_parallel(logits, targets, epsilon: float, split) -> Optional[torch.Tensor]:
    """The class-parallel loss of logits split by ``split``, None for whole ones."""
    if split is None or split.axis.size == 1:
        return None
    return _ClassParallelCE.apply(logits, targets, split, float(epsilon))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, split=None) -> torch.Tensor:
    """Plain mean CE over the batch (F.cross_entropy semantics), in fp32.
    ``split``: the classifier's ``Split`` when ``logits`` are this rank's
    columns of class-sharded logits."""
    sharded = _class_parallel(logits, targets, 0.0, split)
    if sharded is not None:
        return sharded
    logprobs = F.log_softmax(logits.float(), dim=-1)
    return -logprobs.gather(1, targets.long()[:, None])[:, 0].mean()


def cross_entropy_label_smooth(logits: torch.Tensor, targets: torch.Tensor,
                               num_classes: int, epsilon: float = 0.1,
                               split=None) -> torch.Tensor:
    """CrossEntropyLabelSmooth: smoothed one-hot targets,
    loss = (−targets · logprobs).mean(0).sum(). ``split`` as for
    ``cross_entropy``."""
    sharded = _class_parallel(logits, targets, epsilon, split)
    if sharded is not None:
        return sharded
    logprobs = F.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(targets.long(), num_classes).float()
    smoothed = (1.0 - epsilon) * one_hot + epsilon / num_classes
    return torch.sum(torch.mean(-smoothed * logprobs, dim=0))
