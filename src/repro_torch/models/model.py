"""Transformer stack for dense decoders, encoders, SSM (RWKV6) and hybrid
(Mamba + attention) models with dense FFNs.

Params tree (the reference's, with the stacked ``blocks/pos{j}`` leaves
unstacked into one dict per layer, ``i = block * period + j``):
    embed/w            (vocab, d)          [if vocab_size > 0 and no in_proj]
    in_proj/w          (input_embed_dim,d) [if input_embed_dim > 0]
    layers/{i}/...     ln1, attn | mamba, ln2, ffn of layer i; or ln1, rwkv,
                       ln2 (the RWKV6 block carries its own channel mix)
    final_norm/scale
    unembed/w          (d, vocab)          [if has_lm_head and not tied]

Layers run in a Python loop where the reference scans over blocks of
``block_period`` layers; in training each layer is checkpointed
(``torch.utils.checkpoint``, non-reentrant) where the reference wraps each
block in ``jax.checkpoint``.  MoE layers are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import trainable
from repro_torch.common.types import (FFNKind, LayerKind, ModelConfig,
                                      resolve_device, torch_dtype)
from repro_torch.models.layers import (attention, embed, ffn, mamba, norms,
                                       rwkv6)


@dataclass
class FwdCtx:
    """Per-call forward options."""

    mode: str = "train"              # train | prefill
    attn_impl: str = "kernel"        # naive | kernel
    attn_block: int = 512            # tile of the plain attention versions
    ssm_impl: str = "kernel"         # naive | kernel (Mamba and RWKV6 scans)
    remat: bool = True


def _check_supported(cfg: ModelConfig):
    for fk in cfg.ffn_kinds:
        if fk != FFNKind.DENSE:
            raise NotImplementedError(
                f"{cfg.name}: only dense FFNs are ported (got {fk.value})")


def _layer_init(gen, cfg: ModelConfig, kind: LayerKind, dtype):
    d = cfg.d_model
    p = {"ln1": norms.rms_init(d, dtype, gen.device)}
    if kind == LayerKind.ATTENTION:
        p["attn"] = attention.init(gen, cfg, dtype)
    elif kind == LayerKind.MAMBA:
        p["mamba"] = mamba.init(gen, cfg, dtype)
    else:
        p["rwkv"] = rwkv6.init(gen, cfg, dtype)
    p["ln2"] = norms.rms_init(d, dtype, gen.device)
    if kind != LayerKind.RWKV6:      # the RWKV6 block has its own channel mix
        p["ffn"] = ffn.init(gen, cfg, dtype)
    return p


def _layer_apply(lp, x, cfg: ModelConfig, kind: LayerKind, ctx: FwdCtx,
                 positions, segment_ids):
    h = norms.rms_apply(lp["ln1"], x, cfg.norm_eps)
    if kind == LayerKind.ATTENTION:
        x = x + attention.apply(lp["attn"], h, cfg, positions=positions,
                                segment_ids=segment_ids, impl=ctx.attn_impl,
                                block=ctx.attn_block)
    elif kind == LayerKind.MAMBA:
        x = x + mamba.apply(lp["mamba"], h, cfg, impl=ctx.ssm_impl)
    else:
        x = x + rwkv6.time_mix(lp["rwkv"], h, cfg, impl=ctx.ssm_impl)
        h2 = norms.rms_apply(lp["ln2"], x, cfg.norm_eps)
        return x + rwkv6.channel_mix(lp["rwkv"], h2, cfg)
    h2 = norms.rms_apply(lp["ln2"], x, cfg.norm_eps)
    return x + ffn.apply(lp["ffn"], h2, cfg)


def init(cfg: ModelConfig, seed: int = 0, device="cuda", gen=None):
    """Random parameters (a tree of leaf tensors that require grad)."""
    _check_supported(cfg)
    if gen is None:
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dtype = torch_dtype(cfg.param_dtype)
    params: dict = {}
    if cfg.vocab_size > 0 and cfg.input_embed_dim == 0:
        params["embed"] = embed.init(gen, cfg.vocab_size, cfg.d_model, dtype)
    if cfg.input_embed_dim > 0:
        w = torch.randn((cfg.input_embed_dim, cfg.d_model), generator=gen,
                        device=gen.device) * cfg.input_embed_dim ** -0.5
        params["in_proj"] = {"w": w.to(dtype)}
    params["layers"] = [_layer_init(gen, cfg, kind, dtype)
                        for kind in cfg.layer_kinds]
    params["final_norm"] = norms.rms_init(cfg.d_model, dtype, gen.device)
    if cfg.has_lm_head and cfg.vocab_size > 0 and not cfg.tie_embeddings:
        params["unembed"] = embed.unembed_init(gen, cfg.d_model, cfg.vocab_size,
                                               dtype)
    return trainable(params)


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, segment_ids=None, ctx: FwdCtx | None = None):
    """Returns (logits_or_hidden, None, aux dict) — the reference's triple,
    with no cache."""
    _check_supported(cfg)
    ctx = ctx or FwdCtx()
    compute_dtype = torch_dtype(cfg.dtype)
    if embeds is not None:
        x = embeds.to(compute_dtype)
        if "in_proj" in params:
            x = x @ params["in_proj"]["w"].to(compute_dtype)
    else:
        x = embed.encode(params["embed"], tokens, compute_dtype)

    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)

    remat = (ctx.mode == "train" and cfg.remat and ctx.remat
             and torch.is_grad_enabled())
    for lp, kind in zip(params["layers"], cfg.layer_kinds):
        if remat:
            x = checkpoint(_layer_apply, lp, x, cfg, kind, ctx, positions,
                           segment_ids, use_reentrant=False)
        else:
            x = _layer_apply(lp, x, cfg, kind, ctx, positions, segment_ids)

    x = norms.rms_apply(params["final_norm"], x, cfg.norm_eps)
    nan = torch.full((), float("nan"), device=x.device)
    aux = {
        "lb_loss": torch.zeros((), device=x.device),
        # NaN (not 0.0): the model has no MoE layers
        "moe_drop_rate": nan,
        "moe_imbalance": nan,
    }
    if not (cfg.has_lm_head and cfg.vocab_size > 0):
        return x, None, aux
    if cfg.tie_embeddings:
        logits = embed.decode(params["embed"], x)
    else:
        logits = embed.unembed(params["unembed"], x)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits, None, aux
