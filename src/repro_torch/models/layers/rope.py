"""Rotary position embeddings (split halves, not interleaved)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None):
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # torch.full, not torch.tensor: no blocking host-to-device copy a call
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exponent)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (hd/2,)
    angles = positions.float()[..., None] * freqs                # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                        # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
