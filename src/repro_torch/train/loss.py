"""Losses."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Mean CE over labels >= 0 (packed padding uses -1)."""
    return masked_cross_entropy(logits, labels, labels >= 0, z_loss=z_loss)


def masked_cross_entropy(logits, labels, mask, *, z_loss: float = 0.0):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom


def token_accuracy(logits, labels):
    pred = torch.argmax(logits, dim=-1)
    mask = (labels >= 0).float()
    correct = (pred == labels).float() * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
