"""Serving steps: prefill (forward over the prompt) and batched decode.

Continuous batching (``repro_torch.serve.engine`` drives it; the helpers
here are the real-model substrate):

  * the decode batch dimension holds *independent requests* — ``pos`` may
    be a ``(B,)`` tensor of per-row positions, and each row's attention
    only sees its own cache entries (per-row ``kpos`` validity masks, see
    ``repro_torch.models.layers.attention.attend_cache``);
  * requests join/leave the batch only between decode steps:
    `clear_cache_row` resets a vacated row and `merge_cache_row` copies a
    prefilled single-request cache into it (the KV handoff of
    prefill/decode disaggregation);
  * `prefill_into_cache` is the prefill-worker half: one request at its
    exact length (no padding), returning the last-token logits plus the
    cache to hand off.

Caches are the model's per-layer list (``model.init_cache``), every leaf
``(B, ...)``.  Decode writes them in place and returns them; the row helpers
write in place too and return the destination, except `extract_cache_row`,
which copies.  Every step runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.common.types import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models.layers import embed as embed_lib
from repro_torch.models.model import FwdCtx


def device_of(params) -> torch.device:
    """The device a model's params live on (its final norm's)."""
    return params["final_norm"]["scale"].device


def make_prefill_step(cfg: ModelConfig, ctx: Optional[FwdCtx] = None,
                      last_only: bool = True) -> Callable:
    """prefill(params, batch) -> logits.

    Serving prefill only needs the *last* position's logits (next-token
    sampling), so the (B, S, vocab) tensor is not made.  Encoder-only models
    (``causal=False``) keep the full output.  Batched prompts are
    right-padded to a shared S; ``batch["lengths"]`` ((B,) prompt lengths)
    selects each request's own last valid position.  Like the reference's,
    the last-only logits skip ``logit_softcap``."""
    ctx = ctx or FwdCtx(mode="prefill", remat=False)
    if last_only and cfg.is_decoder and cfg.has_lm_head:
        ctx = dataclasses.replace(ctx, return_hidden=True)

    @torch.no_grad()
    def prefill(params, batch):
        dev = device_of(params)
        if "tokens" in batch:
            seg = batch.get("segment_ids")
            out, _, _ = model_lib.forward(
                params, cfg, tokens=torch.as_tensor(batch["tokens"], device=dev),
                segment_ids=None if seg is None else torch.as_tensor(seg, device=dev),
                ctx=ctx)
        else:
            out, _, _ = model_lib.forward(
                params, cfg, embeds=torch.as_tensor(batch["frame_embeds"], device=dev),
                ctx=ctx)
        if ctx.return_hidden:
            lengths = batch.get("lengths")
            if lengths is not None:
                idx = torch.clamp(torch.as_tensor(lengths, device=dev).long() - 1,
                                  0, out.shape[1] - 1)
                h_last = torch.take_along_dim(out, idx[:, None, None], dim=1)
            else:
                h_last = out[:, -1:]
            if cfg.tie_embeddings or "unembed" not in params:
                return embed_lib.decode(params["embed"], h_last)
            return embed_lib.unembed(params["unembed"], h_last)
        return out

    return prefill


def make_decode_step(cfg: ModelConfig, ctx: Optional[FwdCtx] = None) -> Callable:
    """decode(params, caches, tokens (B,), pos () or (B,)) -> (logits, caches).

    A ``(B,)`` pos decodes a continuous batch: rows advance their own
    position clocks, so requests at different depths share one step."""
    base = ctx if ctx is not None else FwdCtx(remat=False)

    def decode(params, caches, tokens, pos):
        logits, caches, _ = model_lib.decode_step(params, cfg, tokens, caches,
                                                  pos, ctx=base)
        return logits, caches

    return decode


def greedy_generate(cfg: ModelConfig, params, prompt, max_new: int,
                    max_len: int, kv_dtype=torch.float32):
    """Batched greedy decoding on the params' device: prompt (B, S) ->
    tokens (B, S + max_new)."""
    dev = device_of(params)
    prompt = torch.as_tensor(prompt, device=dev)
    B, S = prompt.shape
    caches = model_lib.init_cache(cfg, B, max_len, kv_dtype, device=dev)
    decode = make_decode_step(cfg)
    tok = prompt[:, 0]
    out = [tok]
    for t in range(S + max_new - 1):
        logits, caches = decode(params, caches, tok, t)
        if t + 1 < S:
            tok = prompt[:, t + 1]
        else:
            tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        out.append(tok)
    return torch.stack(out, dim=1)


# --------------------------------------------------------------------------- #
# Disaggregated prefill/decode: KV handoff between worker pools
# --------------------------------------------------------------------------- #
def prefill_into_cache(cfg: ModelConfig, params, prompt, max_len: int,
                       kv_dtype=torch.float32, ctx: Optional[FwdCtx] = None):
    """Prefill-worker step: run one request's prompt (B, S) — typically
    B = 1, exact length, no padding — through the cached decode path,
    returning ``(last_logits (B, vocab), caches)``.

    Teacher-forcing through `decode_step` keeps prefill and decode on the
    *same* numerical path, which is what makes the handoff bit-exact."""
    dev = device_of(params)
    prompt = torch.as_tensor(prompt, device=dev)
    caches = model_lib.init_cache(cfg, prompt.shape[0], max_len, kv_dtype,
                                  device=dev)
    return chunk_step(cfg, params, caches, prompt, 0, ctx)


def chunk_step(cfg: ModelConfig, params, caches, toks, pos0: int,
               ctx: Optional[FwdCtx] = None):
    """Teacher-force ``toks`` (B, n) through `decode_step` at positions
    ``pos0 ..``: the reference's jitted chunk scan, one step a token.
    Returns ``(last_logits (B, vocab), caches)``."""
    decode = make_decode_step(cfg, ctx)
    logits = None
    for t in range(toks.shape[1]):
        logits, caches = decode(params, caches, toks[:, t], pos0 + t)
    return logits, caches


def pow2_chunks(length: int, chunk: int) -> list:
    """Decompose a prompt length into a bounded set of chunk sizes: full
    ``chunk``-token blocks, then a descending power-of-two decomposition
    of the remainder.  Any length therefore takes at most
    ``1 + log2(chunk)`` distinct chunk shapes ({chunk} ∪ {pow2 < chunk})
    — the chunked-prefill analogue of the engine's pow2 batch buckets.

    >>> pow2_chunks(45, 16)
    [16, 16, 8, 4, 1]
    >>> sum(pow2_chunks(45, 16))
    45
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    out = []
    rem = int(length)
    while rem >= chunk:
        out.append(chunk)
        rem -= chunk
    tail = []
    p = 1
    while rem:
        if rem & p:
            tail.append(p)
            rem -= p
        p <<= 1
    out.extend(reversed(tail))
    return out


def prefill_into_cache_chunked(cfg: ModelConfig, params, prompt,
                               max_len: int, kv_dtype=torch.float32,
                               chunk: int = 16):
    """`prefill_into_cache`, split into `pow2_chunks`-sized chunks.

    Token-identical to the one-shot version (the same per-token decode
    path), but each chunk returns to the caller, so a serving loop can
    interleave decode steps with a long prompt's prefill.  Returns
    ``(last_logits (B, vocab), caches)``."""
    dev = device_of(params)
    toks = torch.as_tensor(prompt, device=dev)
    caches = model_lib.init_cache(cfg, toks.shape[0], max_len, kv_dtype,
                                  device=dev)
    logits, pos0 = None, 0
    for clen in pow2_chunks(toks.shape[1], chunk):
        logits, caches = chunk_step(cfg, params, caches,
                                    toks[:, pos0:pos0 + clen], pos0)
        pos0 += clen
    return logits, caches


def _fill(a) -> int:
    """The fresh-init value of a cache leaf: -1 for ``kpos``, else 0."""
    return -1 if not a.dtype.is_floating_point else 0


def extract_cache_row(caches, row: int):
    """Inverse of `merge_cache_row`: a copy of batch row ``row`` as a B=1
    cache — the state that leaves with a preempted request (a later re-join
    merges it back) or rides a device-to-device handoff."""
    return tree_map(lambda a: a[row:row + 1].clone(), caches)


def clear_cache_row(caches, row: int):
    """Reset batch row ``row`` to the fresh-init state (zeros for KV/SSM
    state, -1 for ``kpos``), in place — called when a request leaves the
    continuous batch so the next occupant never sees its entries."""
    tree_map(lambda a: a[row].fill_(_fill(a)), caches)
    return caches


def merge_cache_row(dst, src, row: int, src_row: int = 0):
    """KV handoff: copy request ``src_row`` of a prefill-worker cache into
    batch row ``row`` of a decode-worker cache, in place.

    The source's sequence capacity may be smaller than the destination's:
    entries land in the leading slots, which is exact because slot =
    pos % C and prefill only wrote pos < C_src ≤ C_dst (ring caches clamp
    both to the window).  The row is reset first, so stale entries past the
    source capacity do not survive the handoff."""
    def place(d, s):
        s_r = s[src_row].to(device=d.device, dtype=d.dtype)
        if d.shape[1:] == s.shape[1:]:
            d[row].copy_(s_r)
        else:
            d[row].fill_(_fill(d))
            d[row, :s.shape[1]].copy_(s_r)
        return d

    return tree_map(place, dst, src)
