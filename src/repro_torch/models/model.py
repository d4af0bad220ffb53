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

Decode caches mirror the params: a list with one dict per layer,
``{"attn": ...}``, ``{"mamba": ...}`` or ``{"rwkv": ...}`` (the reference
stacks them per pattern position, ``pos{j}``, with a leading ``n_blocks``
axis).  A decode step writes each layer's cache in place and returns the
list.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import trace
from repro_torch.common.pytree import trainable
from repro_torch.common.types import (FFNKind, LayerKind, ModelConfig,
                                      resolve_device, torch_dtype)
from repro_torch.models.layers import (attention, embed, ffn, mamba, moe,
                                       norms, rwkv6)
from repro_torch.sharding.local import is_dtensor


@dataclass
class FwdCtx:
    """Per-call forward options."""

    mode: str = "train"              # train | prefill | decode
    attn_impl: str = "kernel"        # naive | kernel
    attn_block: int = 512            # tile of the plain attention versions
    ssm_impl: str = "kernel"         # naive | kernel | chunked (Mamba, RWKV6)
    moe_impl: str = "capacity"       # dense | capacity | ep (with shard_ctx)
    capacity_factor: float = 2.0     # (moe.apply's own default is 1.25)
    moe_chunk_tokens: int = 0        # >0: chunked+checkpointed dispatch
    return_hidden: bool = False      # skip the LM head
    decode_pos: Any = None           # scalar or (B,) positions in decode mode
    remat: bool = True
    # (mesh, batch_axes, model_axes): this rank's share of the sharded Mamba
    # scan and, with moe_impl "ep", of the sharded MoE paths; None: unsharded
    shard_ctx: Any = None
    # The reference's sharding hooks (``launch/dryrun.py`` makes them: each
    # a DTensor redistribute, the counterpart of with_sharding_constraint);
    # None leaves a path as it is.
    moe_constrain: Optional[Callable] = None      # (E, C, d) dispatch buffers
    logits_constrain: Optional[Callable] = None   # e.g. shard the vocab dim
    block_constrain: Optional[Callable] = None    # f(layer params, layer index):
                                                  # ZeRO-3 gather (bwd: reduce-scatter)
    hidden_constrain: Optional[Callable] = None   # pin (B, S, d) at each block


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
                 ctx: FwdCtx, positions, segment_ids, cache=None, index=None,
                 restarts=None):
    """Returns (x, moe_out): moe_out is None for a layer without MoE, else
    (lb, drop_rate, imbalance), the two stats detached.  With the layer's
    ``cache`` (decode) the layer writes it in place.  ``restarts``: the
    rows' ``mamba.Restarts``, made once a forward.  ``index`` (the layer's
    place in the stack) applies ``ctx``'s hidden constraint at the start of
    each block of ``block_period`` layers and its block constraint to the
    layer's params, inside the layer's checkpoint as the reference applies
    them inside its checkpointed block: the backward gathers again.  The
    hidden constraint also pins each sublayer's output before its residual
    add (DTensor would otherwise carry a partial sum on into strided shards
    that its matmul rules do not take; GSPMD needs no such pin)."""
    pin = _keep
    if index is not None:
        if ctx.hidden_constrain is not None:
            pin = ctx.hidden_constrain
            if index % cfg.block_period == 0:
                # anchor the activation layout every block (stops sharding drift)
                x = pin(x)
        if ctx.block_constrain is not None:
            lp = ctx.block_constrain(lp, index)
    h = norms.rms_apply(lp["ln1"], x, cfg.norm_eps)
    if kind == LayerKind.ATTENTION:
        if cache is None:
            y = attention.apply(lp["attn"], h, cfg, positions=positions,
                                segment_ids=segment_ids, impl=ctx.attn_impl,
                                block=ctx.attn_block)
        else:
            y, _ = attention.apply(lp["attn"], h, cfg, cache=cache["attn"],
                                   decode_pos=ctx.decode_pos)
    elif kind == LayerKind.MAMBA:
        # the chunked scan only outside training, as in the reference (whose
        # "xla" then takes the sharded scan under shard_ctx, as naive does here)
        impl = "naive" if ctx.mode == "train" and ctx.ssm_impl == "chunked" \
            else ctx.ssm_impl
        if cache is None:
            with trace.span("layer.mamba", cat="layer", device=True, layer=index,
                            microbatch=trace.microbatch(),
                            recompute=torch._C._current_autograd_node() is not None):
                y = mamba.apply(lp["mamba"], h, cfg, impl=impl, shard_ctx=ctx.shard_ctx,
                                segment_ids=segment_ids, restarts=restarts)
        else:
            y, _ = mamba.apply(lp["mamba"], h, cfg, cache=cache["mamba"], impl=impl)
    else:
        r_cache = None if cache is None else cache["rwkv"]
        y = rwkv6.time_mix(lp["rwkv"], h, cfg, cache=r_cache, impl=ctx.ssm_impl)
        x = x + (pin(y) if cache is None else y[0])
        h2 = norms.rms_apply(lp["ln2"], x, cfg.norm_eps)
        y2 = rwkv6.channel_mix(lp["rwkv"], h2, cfg, cache=r_cache)
        return x + (pin(y2) if cache is None else y2[0]), None
    x = x + pin(y)
    h2 = norms.rms_apply(lp["ln2"], x, cfg.norm_eps)
    if ffn_kind == FFNKind.MOE:
        y2, lb, st = moe.apply(lp["moe"], h2, cfg, impl=ctx.moe_impl,
                               capacity_factor=ctx.capacity_factor,
                               constrain=ctx.moe_constrain,
                               chunk_tokens=ctx.moe_chunk_tokens,
                               shard_ctx=ctx.shard_ctx, with_stats=True)
        return x + pin(y2), (lb, st["drop_rate"].detach(), st["imbalance"].detach())
    return x + pin(ffn.apply(lp["ffn"], h2, cfg)), None


def _keep(x):
    return x


def default_positions(x):
    """(B, S) positions 0 .. S-1 for x (B, S, ...); for a DTensor, placed as
    x's rows (not a global tensor on every rank)."""
    B, S = x.shape[0], x.shape[1]
    ar = torch.arange(S, device=x.device)
    if is_dtensor(x):
        return torch.zeros_like(x[:, :, 0], dtype=torch.int64) + ar
    return ar[None].expand(B, S)


def layer_fn(cfg: ModelConfig, ctx: FwdCtx | None = None):
    """``f(layer_params, x, positions, segment_ids) -> x``: one layer as
    ``forward`` runs it (checkpointed in training while gradients are on),
    for a stack whose layers share one kind and FFN (the pipeline executor
    stacks them, ``core.pipeline.executor.stack_layers``)."""
    ctx = ctx or FwdCtx()
    if len(set(zip(cfg.layer_kinds, cfg.ffn_kinds))) != 1:
        raise ValueError(f"{cfg.name}: layers of several kinds do not stack")
    kind, fk = cfg.layer_kinds[0], cfg.ffn_kinds[0]

    def f(lp, x, positions, segment_ids):
        if ctx.mode == "train" and cfg.remat and ctx.remat and torch.is_grad_enabled():
            return checkpoint(_layer_apply, lp, x, cfg, kind, fk, ctx, positions,
                              segment_ids, None, use_reentrant=False)[0]
        return _layer_apply(lp, x, cfg, kind, fk, ctx, positions, segment_ids)[0]

    return f


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


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_dtype=torch.bfloat16, device="cuda"):
    """Per-layer decode caches (the list ``forward`` takes as ``caches``):
    KV rings for attention layers (in ``kv_dtype``), conv window and fp32
    state for Mamba layers, token shifts and fp32 WKV state for RWKV6."""
    dev = resolve_device(device)
    caches = []
    for kind in cfg.layer_kinds:
        if kind == LayerKind.ATTENTION:
            caches.append({"attn": attention.init_cache(cfg, batch, max_len,
                                                        kv_dtype, dev)})
        elif kind == LayerKind.MAMBA:
            caches.append({"mamba": mamba.init_cache(cfg, batch, device=dev)})
        else:
            caches.append({"rwkv": rwkv6.init_cache(cfg, batch, device=dev)})
    return caches


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, segment_ids=None, caches=None,
            ctx: FwdCtx | None = None):
    """Returns (logits_or_hidden, caches, aux dict), the reference's triple.
    With ``caches`` (decode: x is (B, 1), positions from ``ctx.decode_pos``)
    each layer's cache is written in place and the list is returned; else
    the second item is None."""
    ctx = ctx or FwdCtx()
    compute_dtype = torch_dtype(cfg.dtype)
    if embeds is not None:
        x = embeds.to(compute_dtype)
        if "in_proj" in params:
            x = x @ params["in_proj"]["w"].to(compute_dtype)
    else:
        x = embed.encode(params["embed"], tokens, compute_dtype)

    B, S = x.shape[0], x.shape[1]
    if positions is None and ctx.mode != "decode":
        positions = default_positions(x)

    remat = (ctx.mode == "train" and cfg.remat and ctx.remat
             and torch.is_grad_enabled())
    restarts = None
    if (cfg.ssm_segment_reset and caches is None and segment_ids is not None
            and LayerKind.MAMBA in cfg.layer_kinds and not is_dtensor(x)):
        restarts = mamba.make_restarts(segment_ids, cfg.ssm_d_conv,
                                       kernel=ctx.ssm_impl == "kernel")
    lb = drop = imb = torch.zeros((), device=x.device)
    for i, (lp, kind, fk) in enumerate(zip(params["layers"], cfg.layer_kinds,
                                           cfg.ffn_kinds)):
        cache = caches[i] if caches is not None else None
        if remat:
            x, mo = checkpoint(_layer_apply, lp, x, cfg, kind, fk, ctx,
                               positions, segment_ids, cache, i, restarts,
                               use_reentrant=False)
        else:
            x, mo = _layer_apply(lp, x, cfg, kind, fk, ctx, positions,
                                 segment_ids, cache, i, restarts)
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
    if ctx.return_hidden or not (cfg.has_lm_head and cfg.vocab_size > 0):
        return x, caches, aux
    if cfg.tie_embeddings:
        logits = embed.decode(params["embed"], x)
    else:
        logits = embed.unembed(params["unembed"], x)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if ctx.logits_constrain is not None:
        logits = ctx.logits_constrain(logits)
    return logits, caches, aux


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, token, caches, pos,
                ctx: FwdCtx | None = None):
    """One decode step. token: (B,) (or (B, 1)) int; pos: a scalar, or a
    (B,) tensor of per-row positions (continuous batching, see
    ``repro_torch.serve``).  Returns (logits (B, vocab), caches, aux), the
    caches written in place."""
    dev = params["final_norm"]["scale"].device
    token = torch.as_tensor(token, device=dev)
    if token.ndim == 1:
        token = token[:, None]
    pos = attention.check_decode_pos(pos, token.shape[0], dev)
    ctx = dataclasses.replace(ctx or FwdCtx(remat=False), mode="decode",
                              decode_pos=pos)
    logits, caches, aux = forward(params, cfg, tokens=token, caches=caches,
                                  ctx=ctx)
    return logits[:, 0], caches, aux
