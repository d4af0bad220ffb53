"""Transformer stack for dense and MoE decoders, encoders, SSM (RWKV6) and
hybrid (Mamba + attention, MoE on every other layer) models.

Params tree (the reference's, with the stacked ``blocks/pos{j}`` leaves
unstacked into one dict per layer, ``i = block * period + j``):
    embed/w            (vocab, d)          [if vocab_size > 0 and no in_proj]
    in_proj/w          (input_embed_dim,d) [if input_embed_dim > 0]
    layers/{i}/...     ln1, attn | mamba, ln2, ffn | moe of layer i; or ln1,
                       rwkv, ln2 (the RWKV6 block carries its own channel mix)
    final_norm/scale
    unembed/w          (d, vocab)          [if has_lm_head and not tied]

Layers run in a Python loop where the reference scans over blocks of
``block_period`` layers; in training each layer is checkpointed
(``torch.utils.checkpoint``, non-reentrant) where the reference wraps each
block in ``jax.checkpoint``; a checkpointed layer returns its first
forward's MoE stats (the recompute's outputs are discarded).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.pytree import trainable
from repro_torch.common.types import (FFNKind, LayerKind, ModelConfig,
                                      resolve_device, torch_dtype)
from repro_torch.models.layers import (attention, embed, ffn, mamba, moe,
                                       norms, rwkv6)


@dataclass
class FwdCtx:
    """Per-call forward options."""

    mode: str = "train"              # train | prefill
    attn_impl: str = "kernel"        # naive | kernel
    attn_block: int = 512            # tile of the plain attention versions
    ssm_impl: str = "kernel"         # naive | kernel (Mamba and RWKV6 scans)
    moe_impl: str = "capacity"       # dense | capacity
    capacity_factor: float = 2.0     # (moe.apply's own default is 1.25)
    moe_chunk_tokens: int = 0        # >0: chunked+checkpointed dispatch
    remat: bool = True


def _layer_init(gen, cfg: ModelConfig, kind: LayerKind, ffn_kind: FFNKind,
                dtype):
    d = cfg.d_model
    p = {"ln1": norms.rms_init(d, dtype, gen.device)}
    if kind == LayerKind.ATTENTION:
        p["attn"] = attention.init(gen, cfg, dtype)
    elif kind == LayerKind.MAMBA:
        p["mamba"] = mamba.init(gen, cfg, dtype)
    else:
        p["rwkv"] = rwkv6.init(gen, cfg, dtype)
    p["ln2"] = norms.rms_init(d, dtype, gen.device)
    if kind == LayerKind.RWKV6:      # the RWKV6 block has its own channel mix
        return p
    if ffn_kind == FFNKind.MOE:
        p["moe"] = moe.init(gen, cfg, dtype)
    else:
        p["ffn"] = ffn.init(gen, cfg, dtype)
    return p


def _layer_apply(lp, x, cfg: ModelConfig, kind: LayerKind, ffn_kind: FFNKind,
                 ctx: FwdCtx, positions, segment_ids):
    """Returns (x, moe_out): moe_out is None for a layer without MoE, else
    (lb, drop_rate, imbalance), the two stats detached."""
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
        return x + rwkv6.channel_mix(lp["rwkv"], h2, cfg), None
    h2 = norms.rms_apply(lp["ln2"], x, cfg.norm_eps)
    if ffn_kind == FFNKind.MOE:
        y2, lb, st = moe.apply(lp["moe"], h2, cfg, impl=ctx.moe_impl,
                               capacity_factor=ctx.capacity_factor,
                               chunk_tokens=ctx.moe_chunk_tokens, with_stats=True)
        return x + y2, (lb, st["drop_rate"].detach(), st["imbalance"].detach())
    return x + ffn.apply(lp["ffn"], h2, cfg), None


def init(cfg: ModelConfig, seed: int = 0, device="cuda", gen=None):
    """Random parameters (a tree of leaf tensors that require grad)."""
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
    params["layers"] = [_layer_init(gen, cfg, kind, fk, dtype)
                        for kind, fk in zip(cfg.layer_kinds, cfg.ffn_kinds)]
    params["final_norm"] = norms.rms_init(cfg.d_model, dtype, gen.device)
    if cfg.has_lm_head and cfg.vocab_size > 0 and not cfg.tie_embeddings:
        params["unembed"] = embed.unembed_init(gen, cfg.d_model, cfg.vocab_size,
                                               dtype)
    return trainable(params)


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, segment_ids=None, ctx: FwdCtx | None = None):
    """Returns (logits_or_hidden, None, aux dict) — the reference's triple,
    with no cache."""
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
    lb = drop = imb = torch.zeros((), device=x.device)
    for lp, kind, fk in zip(params["layers"], cfg.layer_kinds, cfg.ffn_kinds):
        if remat:
            x, mo = checkpoint(_layer_apply, lp, x, cfg, kind, fk, ctx,
                               positions, segment_ids, use_reentrant=False)
        else:
            x, mo = _layer_apply(lp, x, cfg, kind, fk, ctx, positions,
                                 segment_ids)
        if mo is not None:
            # mean drop across MoE layers; worst-layer imbalance (the
            # straggler expert matmul)
            lb, drop, imb = lb + mo[0], drop + mo[1], torch.maximum(imb, mo[2])

    x = norms.rms_apply(params["final_norm"], x, cfg.norm_eps)
    n_moe_layers = sum(1 for f in cfg.ffn_kinds if f == FFNKind.MOE)
    # The reference divides by n_moe_layers * n_blocks, where n_moe_layers
    # already counts every layer: its drop rate is the mean over MoE layers
    # divided by n_blocks (kept as it is; ROADMAP Queue 3 fault 2).
    total_moe = n_moe_layers * (cfg.n_layers // cfg.block_period)
    nan = torch.full((), float("nan"), device=x.device)
    aux = {
        "lb_loss": lb / max(1, n_moe_layers),
        # NaN (not 0.0) when the model has no MoE layers at all
        "moe_drop_rate": drop / total_moe if total_moe else nan,
        "moe_imbalance": imb if total_moe else nan,
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
