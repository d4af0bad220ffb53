"""Token embedding / unembedding."""
from __future__ import annotations

import torch


def init(gen, vocab: int, d: int, dtype=torch.float32, scale: float = 0.02):
    w = torch.randn((vocab, d), generator=gen, device=gen.device) * scale
    return {"w": w.to(dtype)}


def encode(params, tokens, dtype=None):
    out = params["w"][tokens.long()]
    return out.to(dtype) if dtype is not None else out


def decode(params, h):
    return torch.einsum("bsd,vd->bsv", h, params["w"].to(h.dtype))


def unembed_init(gen, d: int, vocab: int, dtype=torch.float32):
    w = torch.randn((d, vocab), generator=gen, device=gen.device) * d ** -0.5
    return {"w": w.to(dtype)}


def unembed(params, h):
    return h @ params["w"].to(h.dtype)
