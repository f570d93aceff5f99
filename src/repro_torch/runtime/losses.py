"""Losses, in plain PyTorch, as the reference's ``runtime/losses.py``."""
from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """logits: (B, T, V); labels: (B, T) integers.  Mean negative
    log-likelihood in float32 over the labels that are not ``ignore_id``."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    safe = torch.where(labels == ignore_id, 0, labels).long()
    picked = lf.gather(-1, safe[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return -((picked - lse) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Shifted LM loss when only tokens are provided."""
    return cross_entropy(logits[:, :-1], tokens[:, 1:])
