"""Vocab-parallel cross-entropy (Megatron-style) over a mesh's model axes.

For 100k–256k vocabularies the (tokens, vocab) logits dominate the LM
head's memory; sharding the vocab keeps each rank's slice small:

  * every model rank computes logits for its vocab slice only (local
    matmul, no communication);
  * softmax statistics reduce over the model axes (tokens-sized messages,
    not logits-sized): the maxima without gradient, the exp-sums by a sum
    whose backward is the identity;
  * the gold logit is found by masking against the rank's vocab offset,
    then summed the same way;
  * the loss and the token count sum over the batch axes (identity
    backward), so every rank returns the mean over the global batch;
  * ``h`` is taken replicated over the model axes and ``w`` over the batch
    axes: each sums its gradient over them (``grad_sum_over``), so a rank's
    ``h`` gradient is the full one for its rows and its ``w`` gradient the
    dense gradient's vocab slice.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.common.collectives import (axis_index, grad_sum_over,
                                            max_over, sum_over)
from repro_torch.launch.mesh import axes_size
from repro_torch.sharding.local import is_dtensor


def make_vocab_parallel_ce(mesh, batch_axes: Tuple[str, ...],
                           model_axes: Tuple[str, ...], vocab: int,
                           tied: bool) -> Optional[Callable]:
    """Returns ce(w, h, labels) -> mean NLL, or None if not applicable.

    w: the head, (vocab, d) when tied (embedding table) else (d, vocab), or
    this rank's vocab slice of it ((vocab / model size, d) or the like).
    h: (B, S, d), this rank's rows of the batch (sharded over
    ``batch_axes``), replicated over the model axes.
    labels: (B, S) int, -1 = ignore.
    """
    if not model_axes:
        return None
    msize = axes_size(mesh, tuple(model_axes))
    if msize == 1 or vocab % msize != 0:
        return None
    v_local = vocab // msize
    vdim = 0 if tied else 1

    def ce(w, h, labels):
        if is_dtensor(h):
            return _ce_dtensor(local_ce, mesh, batch_axes, model_axes, vdim,
                               w, h, labels)
        return local_ce(w, h, labels)

    def local_ce(w, h, labels):
        shard = axis_index(mesh, model_axes)
        if w.shape[vdim] == vocab:
            w = w.narrow(vdim, shard * v_local, v_local)
        elif w.shape[vdim] != v_local:
            raise ValueError(f"head of shape {tuple(w.shape)} holds neither the "
                             f"vocab {vocab} nor a slice of {v_local}")
        w = grad_sum_over(w, mesh, batch_axes).float()
        h = grad_sum_over(h.reshape(-1, h.shape[-1]), mesh, model_axes).float()
        labels = labels.reshape(-1).long()
        logits = h @ (w.t() if tied else w)                      # (T, v_local)
        mx = max_over(logits.amax(-1), mesh, model_axes)
        ex_sum = sum_over(torch.exp(logits - mx[:, None]).sum(-1), mesh, model_axes)
        lse = torch.log(ex_sum) + mx
        ids = labels.clamp(min=0) - shard * v_local
        mine = (ids >= 0) & (ids < v_local)
        gold = logits.gather(-1, ids.clamp(0, v_local - 1)[:, None])[:, 0]
        gold = sum_over(torch.where(mine, gold, torch.zeros_like(gold)), mesh, model_axes)
        mask = (labels >= 0).float()
        loss_sum = sum_over(((lse - gold) * mask).sum(), mesh, batch_axes)
        count = sum_over(mask.sum(), mesh, batch_axes)
        return loss_sum / torch.clamp(count, min=1.0)

    return ce


def _ce_dtensor(ce, mesh, batch_axes, model_axes, vdim, w, h, labels):
    """``ce`` on DTensors, inside ``local_map`` at the reference's specs: the
    head's vocab over the model axes, rows of h and labels over the batch
    axes; the loss replicated.  ``ce`` sums its own gradients (see the
    module doc), so each comes back placed as its input."""
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding.local import local_call, placements
    from repro_torch.sharding.partition import P
    m, b = tuple(model_axes) or None, tuple(batch_axes) or None
    w_spec = P(m, None) if vdim == 0 else P(None, m)
    pl = (placements(mesh, w_spec, w.shape), placements(mesh, P(b, None, None), h.shape),
          placements(mesh, P(b, None), labels.shape))
    return local_call(ce, mesh, (w, h, labels), pl, [Replicate()] * len(pl[0]))
