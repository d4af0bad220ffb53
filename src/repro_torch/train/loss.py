"""Losses."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels):
    """Mean CE over labels >= 0 (packed padding uses -1)."""
    return masked_cross_entropy(logits, labels, labels >= 0)


def masked_cross_entropy(logits, labels, mask):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    return ((lse - gold) * mask).sum() / denom
