"""Supervised contrastive (i2t / t2i) loss.

ref mpreid_tpu/losses/supcon.py::supcon_loss (reference
``loss/supcontrast.py``): CLIP-style supervised contrast between two
feature banks, label-equality positives, temperature 1.0, fp32 logits, the
row max subtracted without a gradient.
"""

from __future__ import annotations

import torch


def supcon_loss(text_features: torch.Tensor, image_features: torch.Tensor,
                t_labels: torch.Tensor, i_labels: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    mask = (t_labels[:, None] == i_labels[None, :]).float()
    logits = torch.matmul(text_features.float(), image_features.float().t()) / temperature
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    log_prob = logits - torch.log(torch.sum(torch.exp(logits), dim=1, keepdim=True))
    mean_log_prob_pos = torch.sum(mask * log_prob, dim=1) / torch.sum(mask, dim=1)
    return -torch.mean(mean_log_prob_pos)
