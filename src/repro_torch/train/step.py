"""Train step for an MLLM, a decoder or an encoder-only model: loss over
microbatches with fp32 gradient accumulation, then AdamW.

The global batch arrives pre-partitioned into N_mb microbatches (leading
axis); the step loops over them, accumulating fp32 gradients, divides by
N_mb and updates.  An fp32 parameter accumulates in its own ``.grad``; any
other (bf16) parameter in an fp32 buffer of its own, to which each
microbatch's gradient is added in fp32, as the reference's scan carry does.
AdamW takes the fp32 gradients and casts each update back to its
parameter's dtype."""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.common import trace
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.common.types import (LayerKind, MLLMConfig, ModelConfig,
                                      resolve_device)
from repro_torch.models import mllm as mllm_lib
from repro_torch.models import model as model_lib
from repro_torch.models.model import FwdCtx
from repro_torch.train.loss import cross_entropy
from repro_torch.train.optim import AdamWConfig, adamw_update

LB_LOSS_WEIGHT = 0.01


def _head_weight(cfg, params):
    """(weight, tied) for the LM head of a decoder param tree."""
    if cfg.tie_embeddings or "unembed" not in params:
        return params["embed"]["w"], True
    return params["unembed"]["w"], False


def make_loss_fn(desc: MLLMConfig | ModelConfig, ctx: FwdCtx | None = None,
                 communicator=None, vocab_ce: Callable | None = None,
                 enc_ctx: FwdCtx | None = None,
                 with_aux: bool = False) -> Callable:
    """loss_fn(params, mb).  An ``MLLMConfig`` takes the multimodal batch of
    ``MixedDataset.materialize``; a decoder ``ModelConfig`` takes packed rows
    (``tokens``, ``labels`` and optional ``positions``, ``segment_ids``, as
    ``data.packing`` makes them); an encoder-only ``ModelConfig`` (one with
    ``input_embed_dim``) takes ``frame_embeds``, ``labels`` (-1 where
    unmasked) and optional ``segment_ids``.

    ``communicator`` (MLLM): reshards the encoder's output to the LLM's
    layout (``core.communicator``).  ``vocab_ce``: a vocab-parallel CE
    ``ce(w, h, labels)`` (``sharding.vocab_ce``) — the forward then returns
    hidden states and the head and CE run through it."""
    ctx = ctx or FwdCtx(mode="train")
    if vocab_ce is not None:
        ctx = dataclasses.replace(ctx, return_hidden=True)

    def finish(ce, aux):
        loss = ce + LB_LOSS_WEIGHT * aux["lb_loss"]
        return (loss, aux) if with_aux else loss

    def head_ce(cfg, head_params, out, labels):
        if vocab_ce is None:
            return cross_entropy(out, labels)
        w, _ = _head_weight(cfg, head_params)
        return vocab_ce(w, out, labels)

    if isinstance(desc, MLLMConfig):
        def loss_fn(params, mb):
            out, aux = mllm_lib.forward_train(params, desc, mb, ctx=ctx,
                                              communicator=communicator,
                                              enc_ctx=enc_ctx)
            return finish(head_ce(desc.llm, params["llm"], out, mb["labels"]), aux)
        return loss_fn

    if desc.input_embed_dim > 0:
        # encoder-only masked prediction (HuBERT-style): labels -1 = unmasked
        def loss_fn(params, mb):
            out, _, aux = model_lib.forward(
                params, desc, embeds=mb["frame_embeds"],
                segment_ids=mb.get("segment_ids"), ctx=ctx)
            return finish(head_ce(desc, params, out, mb["labels"]), aux)
        return loss_fn

    def loss_fn(params, mb):
        out, _, aux = model_lib.forward(
            params, desc, tokens=mb["tokens"], positions=mb.get("positions"),
            segment_ids=mb.get("segment_ids"), ctx=ctx)
        return finish(head_ce(desc, params, out, mb["labels"]), aux)
    return loss_fn


def make_train_step(desc: MLLMConfig | ModelConfig, opt_cfg: AdamWConfig,
                    ctx: FwdCtx | None = None, communicator=None,
                    vocab_ce: Callable | None = None,
                    enc_ctx: FwdCtx | None = None) -> Callable:
    """step(params, opt_state, batch, lr) -> (params, opt_state, metrics).

    ``batch`` leaves carry a leading (N_mb,) microbatch axis.  Params and
    optimizer state are updated in place and returned.  ``communicator``
    and ``vocab_ce`` as in ``make_loss_fn``."""
    loss_fn = make_loss_fn(desc, ctx, communicator, vocab_ce=vocab_ce,
                           enc_ctx=enc_ctx, with_aux=True)
    restarts = (isinstance(desc, ModelConfig) and desc.ssm_segment_reset
                and LayerKind.MAMBA in desc.layer_kinds)

    def train_step(params, opt_state, batch, lr):
        with trace.span("step.train", cat="step"):
            if restarts and getattr(batch, "segment_starts", None) is not None:
                trace.counter("mamba.segment_starts", batch.segment_starts, cat="step")
            return _step(params, opt_state, batch, lr)

    def _step(params, opt_state, batch, lr):
        leaves = tree_leaves(params)
        n_mb = next(iter(batch.values())).shape[0]
        for p in leaves:
            p.grad = None
        # fp32 buffers of the parameters that are not fp32 (a DTensor's
        # buffer takes its placements: each gradient is redistributed to them)
        acc = {id(p): torch.zeros_like(p, dtype=torch.float32)
               for p in leaves if p.dtype != torch.float32}
        loss_sum = drop_sum = imb_max = torch.zeros((), device=leaves[0].device)
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items()}
            trace.set_microbatch(i)
            with trace.span("step.forward", cat="step", device=True, microbatch=i):
                loss, aux = loss_fn(params, mb)
            with trace.span("step.backward", cat="step", device=True, microbatch=i):
                loss.backward()                     # accumulates into p.grad
                for p in leaves:
                    if id(p) in acc:
                        acc[id(p)].add_(_like(p.grad, acc[id(p)]))
                        p.grad = None
                loss_sum = loss_sum + loss.detach()
                drop_sum = drop_sum + aux["moe_drop_rate"].detach()
                imb_max = torch.maximum(imb_max, aux["moe_imbalance"].detach())
        trace.set_microbatch(None)
        with trace.span("step.optimizer", cat="step", device=True):
            grads = tree_map(lambda p: acc.get(id(p), p.grad).div_(n_mb), params)
            new_params, new_opt = adamw_update(opt_cfg, params, grads, opt_state,
                                               lr=lr)
            for p in leaves:
                p.grad = None
        # NaN-preserving aggregates (no-MoE models report NaN, never 0.0)
        metrics = {"loss": loss_sum / n_mb, "moe_drop_rate": drop_sum / n_mb,
                   "moe_imbalance": imb_max}
        return new_params, new_opt, metrics

    return train_step


def _like(g, buf):
    """``g`` in ``buf``'s dtype and, for a DTensor, its placements."""
    if hasattr(buf, "placements") and tuple(g.placements) != tuple(buf.placements):
        g = g.redistribute(buf.device_mesh, buf.placements)
    return g.float()


class DeviceBatch(dict):
    """A batch on the device (``as_tensors``), with what tracing reads from
    its host copy: ``segment_starts``, the steps of its rows at which a
    segment starts (a step whose id differs from the one before), counted
    while ``trace.active()``, else None."""

    segment_starts = None


def as_tensors(batch: dict, device="cuda") -> DeviceBatch:
    """Numpy batch (leading microbatch axis) -> tensors on ``device``; float
    leaves as fp32, integer leaves as int32."""
    dev = resolve_device(device)
    out = DeviceBatch()
    with trace.span("step.h2d", cat="step"):
        for k, v in batch.items():
            v = np.asarray(v)
            dtype = torch.float32 if v.dtype.kind == "f" else torch.int32
            out[k] = torch.as_tensor(v).to(device=dev, dtype=dtype)
        if "segment_ids" in batch and trace.active():
            seg = np.asarray(batch["segment_ids"])
            out.segment_starts = int(np.count_nonzero(seg[..., 1:] != seg[..., :-1]))
    return out
