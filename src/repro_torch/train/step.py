"""Train step for an MLLM or a plain decoder: loss over microbatches with
fp32 gradient accumulation, then AdamW.

The global batch arrives pre-partitioned into N_mb microbatches (leading
axis); the step loops over them, accumulating fp32 gradients in the
parameters' ``.grad`` (params are fp32), divides by N_mb and updates."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.common.types import MLLMConfig, ModelConfig, resolve_device
from repro_torch.models import mllm as mllm_lib
from repro_torch.models import model as model_lib
from repro_torch.models.model import FwdCtx
from repro_torch.train.loss import cross_entropy
from repro_torch.train.optim import AdamWConfig, adamw_update

LB_LOSS_WEIGHT = 0.01


def make_loss_fn(desc: MLLMConfig | ModelConfig, ctx: FwdCtx | None = None,
                 enc_ctx: FwdCtx | None = None,
                 with_aux: bool = False) -> Callable:
    """loss_fn(params, mb).  An ``MLLMConfig`` takes the multimodal batch of
    ``MixedDataset.materialize``; a decoder ``ModelConfig`` takes packed rows
    (``tokens``, ``labels`` and optional ``positions``, ``segment_ids``, as
    ``data.packing`` makes them)."""
    ctx = ctx or FwdCtx(mode="train")

    def finish(ce, aux):
        loss = ce + LB_LOSS_WEIGHT * aux["lb_loss"]
        return (loss, aux) if with_aux else loss

    if isinstance(desc, MLLMConfig):
        def loss_fn(params, mb):
            logits, aux = mllm_lib.forward_train(params, desc, mb, ctx=ctx,
                                                 enc_ctx=enc_ctx)
            return finish(cross_entropy(logits, mb["labels"]), aux)
        return loss_fn

    if desc.input_embed_dim > 0:
        raise NotImplementedError(
            "the encoder-only (masked prediction) loss is not ported yet")

    def loss_fn(params, mb):
        logits, _, aux = model_lib.forward(
            params, desc, tokens=mb["tokens"], positions=mb.get("positions"),
            segment_ids=mb.get("segment_ids"), ctx=ctx)
        return finish(cross_entropy(logits, mb["labels"]), aux)
    return loss_fn


def make_train_step(desc: MLLMConfig | ModelConfig, opt_cfg: AdamWConfig,
                    ctx: FwdCtx | None = None,
                    enc_ctx: FwdCtx | None = None) -> Callable:
    """step(params, opt_state, batch, lr) -> (params, opt_state, metrics).

    ``batch`` leaves carry a leading (N_mb,) microbatch axis.  Params and
    optimizer state are updated in place and returned."""
    loss_fn = make_loss_fn(desc, ctx, enc_ctx=enc_ctx, with_aux=True)

    def train_step(params, opt_state, batch, lr):
        leaves = tree_leaves(params)
        if any(p.dtype != torch.float32 for p in leaves):
            raise ValueError("fp32 gradient accumulation needs fp32 params")
        n_mb = next(iter(batch.values())).shape[0]
        for p in leaves:
            p.grad = None
        loss_sum = drop_sum = imb_max = torch.zeros((), device=leaves[0].device)
        for i in range(n_mb):
            mb = {k: v[i] for k, v in batch.items()}
            loss, aux = loss_fn(params, mb)
            loss.backward()                     # accumulates into p.grad
            loss_sum = loss_sum + loss.detach()
            drop_sum = drop_sum + aux["moe_drop_rate"].detach()
            imb_max = torch.maximum(imb_max, aux["moe_imbalance"].detach())
        grads = tree_map(lambda p: p.grad.div_(n_mb), params)
        new_params, new_opt = adamw_update(opt_cfg, params, grads, opt_state,
                                           lr=lr)
        for p in leaves:
            p.grad = None
        # NaN-preserving aggregates (no-MoE models report NaN, never 0.0)
        metrics = {"loss": loss_sum / n_mb, "moe_drop_rate": drop_sum / n_mb,
                   "moe_imbalance": imb_max}
        return new_params, new_opt, metrics

    return train_step


def as_tensors(batch: dict, device="cuda") -> dict:
    """Numpy batch (leading microbatch axis) -> tensors on ``device``; float
    leaves as fp32, integer leaves as int32."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        dtype = torch.float32 if v.dtype.kind == "f" else torch.int32
        out[k] = torch.as_tensor(v).to(device=dev, dtype=dtype)
    return out
