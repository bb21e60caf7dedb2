"""Losses and classification metrics (counterpart of
``theanompi_tpu.ops.losses``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL over the batch, in fp32. ``labels`` are int class ids."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def classification_error(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Top-1 error rate in [0, 1]."""
    return (logits.argmax(-1) != labels.long()).float().mean()


def topk_error(logits: torch.Tensor, labels: torch.Tensor,
               k: int = 5) -> torch.Tensor:
    """Top-k error rate (the reference reports top-5 for ImageNet)."""
    topk = logits.topk(k, dim=-1).indices
    hit = (topk == labels.long()[:, None]).any(-1)
    return (~hit).float().mean()
