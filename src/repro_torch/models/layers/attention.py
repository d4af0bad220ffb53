"""GQA/MQA attention with packing-aware masking, sliding window and caches.

Implementations of the same math, chosen by ``impl``:

  * ``naive``  — materializes the full score matrix (the oracle);
  * ``kernel`` — packed flash attention: the CUDA kernels K1–K3 on a CUDA
                 tensor, their plain blocked versions on a CPU tensor (the
                 counterpart of the reference's ``chunked`` and ``pallas``,
                 which compute the same function).

``block`` tiles the plain versions; the CUDA kernels tile at a fixed 64 × 64
and ignore it.  Outputs do not depend on either.

Decode (one token against a KV cache) is plain PyTorch, as the reference's
``attend_cache`` is plain ``jnp``: no kernel lies on that branch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers.rope import apply_rope
from repro_torch.sharding.local import is_dtensor

NEG_INF = -1e30
IMPLS = ("naive", "kernel")


def init(gen, cfg: ModelConfig, dtype=torch.float32):
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype)

    s = d ** -0.5
    return {"wq": normal((d, h, hd), s), "wk": normal((d, kh, hd), s),
            "wv": normal((d, kh, hd), s), "wo": normal((h, hd, d), (h * hd) ** -0.5)}


def make_mask(qpos, kpos, *, causal: bool, window: int, seg_q=None, seg_k=None):
    """Boolean mask (broadcast batch, Sq, Sk). True = attend."""
    m = torch.ones(qpos.shape[-1:] + kpos.shape[-1:], dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if window and window > 0:
        m = m & (qpos[:, None] - kpos[None, :] < window)
    m = m[None]
    if seg_q is not None and seg_k is not None:
        m = m & (seg_q[:, :, None] == seg_k[:, None, :])
    return m


def attend_naive(q, k, v, *, causal=True, window=0, seg_q=None, seg_k=None,
                 q_offset=0, scale: Optional[float] = None):
    """q: (B,Sq,H,D); k,v: (B,Sk,Kh,D). Returns (B,Sq,H,D)."""
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Kh, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = make_mask(qpos, kpos, causal=causal, window=window,
                     seg_q=seg_q, seg_k=seg_k)                 # (B?,Sq,Sk)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (e.g. padding segments) -> zero output
    any_valid = torch.any(mask, dim=-1)[:, :, None, None, None]  # (B?,Sq,1,1,1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    out = torch.where(any_valid, out, 0.0)
    return out.reshape(B, Sq, H, D).to(q.dtype)


# --------------------------------------------------------------------------- #
# Decode against a KV cache
# --------------------------------------------------------------------------- #
def attend_cache(q, cache_k, cache_v, kpos, pos, *, window=0, scale=None):
    """Single-step decode. q: (B,1,H,D); cache_k/v: (B,C,Kh,D); kpos: (B,C).

    ``pos`` is a scalar (lockstep batch) or a ``(B,)`` tensor: each row
    attends only to its own entries, ``kpos[b] <= pos[b]``.  The scores and
    the p·V product accumulate in the cache dtype, the softmax runs in fp32
    (exact when caches are fp32), as in the reference."""
    B, _, H, D = q.shape
    Kh = cache_k.shape[2]
    G = H // Kh
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Kh, G, D).to(cache_k.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k).float() * scale
    pos_b = check_decode_pos(pos, B, q.device)[:, None]             # (B, 1)
    valid = (kpos >= 0) & (kpos <= pos_b)
    if window and window > 0:
        valid = valid & (pos_b - kpos < window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(cache_v.dtype), cache_v)
    return out.reshape(B, 1, H, D).to(q.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """KV cache for one attention layer.  Sliding-window archs use a ring of
    ``min(max_len, window)`` slots (write at ``pos % C``); ``kpos`` is per row
    ``(batch, C)``, -1 where a slot holds nothing."""
    C = min(max_len, cfg.window_size) if cfg.window_size else max_len
    shape = (batch, C, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "kpos": torch.full((batch, C), -1, dtype=torch.int32, device=device)}


def kv_cache_bytes(cfg: ModelConfig, seq_len: int,
                   bytes_per_value: int = 2) -> float:
    """Bytes of live KV state for one request at context ``seq_len`` (K + V
    across all layers): the payload a prefill→decode handoff moves."""
    kv_heads = cfg.n_kv_heads or cfg.n_heads or 1
    head_dim = cfg.head_dim or (cfg.d_model // max(cfg.n_heads, 1))
    return 2.0 * cfg.n_layers * kv_heads * head_dim \
        * bytes_per_value * seq_len


def check_decode_pos(pos, B: int, device=None):
    """The decode-position contract: a scalar (rows in lockstep) or a ``(B,)``
    vector of per-row positions.  Returns the ``(B,)`` int32 form; any other
    shape raises (a ``(B, 1)`` array would write KV rows at the wrong slots)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim == 0:
        return pos.expand(B)
    if tuple(pos.shape) != (B,):
        raise ValueError(
            f"decode_pos must be a scalar or shape ({B},), got {tuple(pos.shape)}")
    return pos


def cache_write(cache, k_new, v_new, pos):
    """Write one token (k_new: (B,1,Kh,D)) at each row's ring slot
    ``pos % C``, in place; returns the cache."""
    B, C = cache["k"].shape[0], cache["k"].shape[1]
    pos_b = check_decode_pos(pos, B, cache["k"].device)
    slot = (pos_b % C).long()
    rows = torch.arange(B, device=slot.device)
    cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["kpos"][rows, slot] = pos_b
    return cache


def _decode_dtensor(q, k_new, v_new, cache, pos, window):
    """Decode on DTensor caches whose slots are sharded (the dry run's
    flash-decoding layout, ``launch.dryrun.cache_specs``), inside
    ``local_map``: each rank writes the new token if its slot falls in the
    rank's slice of the ring, scores its slice, and the softmax statistics
    and p·V partials combine over the slot axes (max without gradient, then
    sums).  Rows over the batch axes; q, k_new and v_new whole a row."""
    from repro_torch.common.collectives import axis_index, max_over, sum_over
    from repro_torch.launch.mesh import axes_size
    from repro_torch.sharding.local import axes_of, local_call, placements
    from repro_torch.sharding.partition import P
    mesh = cache["k"].device_mesh
    b, seq = axes_of(cache["k"], 0), axes_of(cache["k"], 1)
    n_seq = axes_size(mesh, seq)
    row = placements(mesh, P(b or None, None, None, None), q.shape)
    pos_pl = placements(mesh, P(b or None), pos.shape)
    c_pl = [list(cache[n].placements) for n in ("k", "v", "kpos")]

    def local(ql, kn, vn, ck, cv, kpos, pos_b):
        B, C_loc = ck.shape[0], ck.shape[1]
        off = axis_index(mesh, seq) * C_loc if seq else 0
        slot = (pos_b % (C_loc * n_seq)).long() - off
        mine = (slot >= 0) & (slot < C_loc)
        slot = slot.clamp(0, C_loc - 1)
        rows = torch.arange(B, device=slot.device)
        keep = mine[:, None, None]
        ck[rows, slot] = torch.where(keep, kn[:, 0].to(ck.dtype), ck[rows, slot])
        cv[rows, slot] = torch.where(keep, vn[:, 0].to(cv.dtype), cv[rows, slot])
        kpos[rows, slot] = torch.where(mine, pos_b, kpos[rows, slot])
        _, _, H, D = ql.shape
        KH = ck.shape[2]
        qg = ql.reshape(B, KH, H // KH, D).to(ck.dtype)
        sc = torch.einsum("bkgd,bskd->bkgs", qg, ck).float() * D ** -0.5
        valid = (kpos >= 0) & (kpos <= pos_b[:, None])
        if window and window > 0:
            valid = valid & (pos_b[:, None] - kpos < window)
        sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
        m = max_over(sc.amax(-1), mesh, seq) if seq else sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        den, num = p.sum(-1), torch.einsum("bkgs,bskd->bkgd", p.to(cv.dtype), cv).float()
        if seq:
            den, num = sum_over(den, mesh, seq), sum_over(num, mesh, seq)
        return (num / den[..., None]).reshape(B, 1, H, D).to(ql.dtype)

    return local_call(local, mesh, (q, k_new, v_new, cache["k"], cache["v"],
                                    cache["kpos"], pos),
                      (row, row, row, *c_pl, pos_pl), row)


def apply(params, x, cfg: ModelConfig, *, positions=None, segment_ids=None,
          cache=None, decode_pos=None, impl: str = "kernel", block: int = 512):
    """Self-attention layer.

    Train/prefill: ``cache`` is None, x is (B,S,d); returns y (B,S,d).
    Decode: ``cache`` is the layer cache, x is (B,1,d), ``decode_pos`` a
    scalar or a (B,) tensor of per-row positions; returns (y, cache), the
    cache written in place."""
    B, S, _ = x.shape
    window = cfg.window_size if cfg.attention_kind == "sliding" else 0
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
    if cache is not None:
        pos = check_decode_pos(decode_pos, B, x.device)
        if cfg.use_rope:
            q = apply_rope(q, pos[:, None], cfg.rope_theta)
            k = apply_rope(k, pos[:, None], cfg.rope_theta)
        if is_dtensor(cache["k"]):
            out = _decode_dtensor(q, k, v, cache, pos, window)
        else:
            cache = cache_write(cache, k, v, pos)
            out = attend_cache(q, cache["k"], cache["v"], cache["kpos"], pos,
                               window=window)
        return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype)), cache
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if impl == "naive":
        out = attend_naive(q, k, v, causal=cfg.causal, window=window,
                           seg_q=segment_ids, seg_k=segment_ids)
    elif impl == "kernel":
        out = kops.packed_flash_attention(
            q, k, v, segment_ids=segment_ids, causal=cfg.causal, window=window,
            block_q=block, block_k=block)
    else:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(x.dtype))
