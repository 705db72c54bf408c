"""Cross-entropy losses.

ref mpreid_tpu/losses/softmax.py::cross_entropy, ::cross_entropy_label_smooth.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain mean CE over the batch (F.cross_entropy semantics), in fp32."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    return -logprobs.gather(1, targets.long()[:, None])[:, 0].mean()


def cross_entropy_label_smooth(logits: torch.Tensor, targets: torch.Tensor,
                               num_classes: int, epsilon: float = 0.1) -> torch.Tensor:
    """CrossEntropyLabelSmooth: smoothed one-hot targets,
    loss = (−targets · logprobs).mean(0).sum()."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    one_hot = F.one_hot(targets.long(), num_classes).float()
    smoothed = (1.0 - epsilon) * one_hot + epsilon / num_classes
    return torch.sum(torch.mean(-smoothed * logprobs, dim=0))
