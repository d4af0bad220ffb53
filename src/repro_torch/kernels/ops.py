"""Kernel entry points in the model's layout."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import mamba_scan_bsd
from repro_torch.kernels.packed_flash_attention import packed_flash_attention_bkgsd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bhsm


def packed_flash_attention(q, k, v, *, segment_ids=None, causal=True,
                           window=0, block_q=512, block_k=512):
    """q: (B, S, H, D); k, v: (B, S, KH, D); segment_ids: (B, S) int32.
    Returns (B, S, H, D) — layout-matched to the model's attention layer."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    if segment_ids is None:
        segment_ids = torch.zeros((B, S), dtype=torch.int32, device=q.device)
    # GQA convention: head h attends through kv head h // G — the
    # (B, S, KH, G, D) reshape groups G consecutive query heads per kv head.
    qt = q.reshape(B, S, KH, G, D).permute(0, 2, 3, 1, 4)   # (B,KH,G,S,D)
    kt = k.permute(0, 2, 1, 3)                              # (B,KH,S,D)
    vt = v.permute(0, 2, 1, 3)
    out = packed_flash_attention_bkgsd(
        qt, kt, vt, segment_ids, segment_ids, causal=causal, window=window,
        block_q=block_q, block_k=block_k)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def rwkv6_scan(r, k, v, w, u):
    """r, k, v, w: (B, S, H, M); u: (H, M).  Returns (y (B, S, H, M), final
    state (B, H, M, M) f32)."""
    rt, kt, vt, wt = (t.permute(0, 2, 1, 3) for t in (r, k, v, w))
    y, s = rwkv6_scan_bhsm(rt, kt, vt, wt, u)
    return y.permute(0, 2, 1, 3), s


def mamba_scan(u, dt, B_t, C_t, A, D):
    """u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,).
    Returns (y (B, S, di), None) — no final state, as in the reference."""
    return mamba_scan_bsd(u, dt, B_t, C_t, A, D), None
