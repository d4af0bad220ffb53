"""GQA/MQA attention with packing-aware masking and sliding window (the
train branch of the reference layer; the decode cache comes later).

Implementations of the same math, chosen by ``impl``:

  * ``naive``  — materializes the full score matrix (the oracle);
  * ``kernel`` — packed flash attention: the CUDA kernels K1–K3 on a CUDA
                 tensor, their plain blocked versions on a CPU tensor (the
                 counterpart of the reference's ``chunked`` and ``pallas``,
                 which compute the same function).

``block`` tiles the plain versions; the CUDA kernels tile at a fixed 64 × 64
and ignore it.  Outputs do not depend on either.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers.rope import apply_rope

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


def apply(params, x, cfg: ModelConfig, *, positions=None, segment_ids=None,
          impl: str = "kernel", block: int = 512):
    """Self-attention layer, train/prefill branch: x (B,S,d) -> (B,S,d)."""
    B, S, _ = x.shape
    window = cfg.window_size if cfg.attention_kind == "sliding" else 0
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(x.dtype))
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
