"""Losses."""
from __future__ import annotations

import torch

from repro_torch.sharding.local import is_dtensor


def cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Mean CE over labels >= 0 (packed padding uses -1)."""
    return masked_cross_entropy(logits, labels, labels >= 0, z_loss=z_loss)


def masked_cross_entropy(logits, labels, mask, *, z_loss: float = 0.0):
    if is_dtensor(logits):
        return _masked_ce_dtensor(logits, labels, mask, z_loss)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom


def _nll_sums(logits, labels, mask, z_loss):
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    mask = mask.float()
    return (nll * mask).sum(), mask.sum()


def _masked_ce_dtensor(logits, labels, mask, z_loss):
    """The CE on DTensors: each rank's rows (the vocab whole, as the
    logits hold it where the vocab-parallel CE does not apply) give a sum
    and a count, partial over the batch axes; their ratio is the global
    mean.  DTensor's own rules would build the logits' gradient at the
    global batch on every rank."""
    from repro_torch.sharding.local import axes_of, local_call, partial_over, placements
    from repro_torch.sharding.partition import P
    mesh = logits.device_mesh
    b = axes_of(logits, 0) or None
    rest = (None,) * (labels.ndim - 1)
    row_pl = [placements(mesh, P(b, *rest, None), logits.shape),
              placements(mesh, P(b, *rest), labels.shape),
              placements(mesh, P(b, *rest), mask.shape)]
    part = partial_over(placements(mesh, P(), ()), mesh, b)
    total, count = local_call(lambda lg, lb, mk: _nll_sums(lg, lb, mk, z_loss), mesh,
                              (logits, labels, mask), row_pl, (part, part))
    return total / torch.clamp(count, min=1.0)


def token_accuracy(logits, labels):
    pred = torch.argmax(logits, dim=-1)
    mask = (labels >= 0).float()
    correct = (pred == labels).float() * mask
    return correct.sum() / torch.clamp(mask.sum(), min=1.0)
