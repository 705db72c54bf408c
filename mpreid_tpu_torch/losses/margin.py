"""Margin-based classifier heads as plain functions over a weight matrix.

ref mpreid_tpu/losses/margin.py::_cosine_logits, ::arcface_logits,
::cosface_logits, ::amsoftmax_logits, ::circle_logits, ::contrastive_loss
(reference ``loss/arcface.py`` and ``loss/metric_learning.py``). The weight
is an explicit argument, (num_classes, feat), except AMSoftmax's, which is
(feat, num_classes). Everything is computed in fp32. All return logits for
cross-entropy, except ``contrastive_loss``, a scalar loss.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .triplet import normalize


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def _cosine_logits(features: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """cos(θ) = norm(x) · norm(W)ᵀ with W of shape (num_classes, feat)."""
    return torch.matmul(normalize(features.float()), normalize(weight.float()).t())


def arcface_logits(features: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                   s: float = 30.0, m: float = 0.50, easy_margin: bool = False,
                   ls_eps: float = 0.0) -> torch.Tensor:
    """ArcFace cos(θ+m) logits."""
    cosine = _cosine_logits(features, weight)
    sine = torch.sqrt(torch.clamp(1.0 - torch.square(cosine), 0.0, 1.0))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        th = math.cos(math.pi - m)
        mm = math.sin(math.pi - m) * m
        phi = torch.where(cosine > th, phi, cosine - mm)
    one_hot = _one_hot(labels, weight.shape[0])
    if ls_eps > 0:
        one_hot = (1 - ls_eps) * one_hot + ls_eps / weight.shape[0]
    return s * (one_hot * phi + (1.0 - one_hot) * cosine)


def cosface_logits(features: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                   s: float = 30.0, m: float = 0.30) -> torch.Tensor:
    """CosFace cos(θ)−m logits."""
    cosine = _cosine_logits(features, weight)
    one_hot = _one_hot(labels, weight.shape[0])
    return s * (one_hot * (cosine - m) + (1.0 - one_hot) * cosine)


def amsoftmax_logits(features: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                     s: float = 30.0, m: float = 0.30) -> torch.Tensor:
    """AMSoftmax logits; ``weight`` is (feat, num_classes), its columns normalised."""
    x = features.float()
    x = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-12)
    w = weight.float()
    w = w / torch.clamp(torch.linalg.norm(w, dim=0, keepdim=True), min=1e-12)
    delt = _one_hot(labels, weight.shape[1]) * m
    return s * (torch.matmul(x, w) - delt)


def circle_logits(features: torch.Tensor, weight: torch.Tensor, labels: torch.Tensor,
                  s: float = 256.0, m: float = 0.25) -> torch.Tensor:
    """CircleLoss class logits; the weighting factors carry no gradient."""
    sim = _cosine_logits(features, weight)
    sim_sg = sim.detach()
    alpha_p = torch.clamp(-sim_sg + 1 + m, min=0.0)
    alpha_n = torch.clamp(sim_sg + m, min=0.0)
    s_p = s * alpha_p * (sim - (1 - m))
    s_n = s * alpha_n * (sim - m)
    one_hot = _one_hot(labels, weight.shape[0])
    return one_hot * s_p + (1.0 - one_hot) * s_n


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     margin: float = 0.3) -> torch.Tensor:
    """Per anchor: the sum of 1 − sim over positive pairs with sim < 1 (self
    similarity ≈ 1 left out) plus the sum of sim over negatives with sim >
    margin; the mean over anchors."""
    f = features.float()
    sim = torch.matmul(f, f.t())
    same = labels[:, None] == labels[None, :]
    zero = torch.zeros_like(sim)
    pos_loss = torch.where(same & (sim < 1.0), 1.0 - sim, zero).sum(dim=1)
    neg_loss = torch.where(~same & (sim > margin), sim, zero).sum(dim=1)
    return torch.mean(pos_loss + neg_loss)
