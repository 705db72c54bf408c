"""The losses of CLIP-ReID's recipe: label-smoothed cross entropy (epsilon
0.1), the batch-hard triplet loss with a margin, and supervised contrast
between images and texts (temperature 1)."""

from __future__ import annotations

import torch


def ce_smooth(logits, labels, num_classes: int, epsilon: float = 0.1):
    logp = torch.log_softmax(logits, dim=-1)
    target = torch.full_like(logp, epsilon / num_classes)
    target[torch.arange(len(labels), device=labels.device), labels] += 1.0 - epsilon
    return (-(target * logp).sum(dim=1)).mean()


def triplet(feat, labels, margin: float):
    sq = (feat * feat).sum(dim=1)
    dist = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2.0 * feat @ feat.t(), min=1e-12))
    same = labels[:, None] == labels[None, :]
    hardest_pos = torch.where(same, dist, torch.full_like(dist, float("-inf"))).amax(dim=1)
    hardest_neg = torch.where(same, torch.full_like(dist, float("inf")), dist).amin(dim=1)
    return torch.relu(hardest_pos - hardest_neg + margin).mean()


def supcon(a, b, labels_a, labels_b):
    """Rows of ``a`` against rows of ``b``: the mean log-probability of the
    rows of ``b`` that share the label."""
    pos = (labels_a[:, None] == labels_b[None, :]).float()
    logits = a @ b.t()
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    logp = logits - torch.log(torch.exp(logits).sum(dim=1, keepdim=True))
    return -((pos * logp).sum(dim=1) / pos.sum(dim=1)).mean()
