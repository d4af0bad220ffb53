"""Normalization layers (RMSNorm / LayerNorm): fp32 math, cast back."""
from __future__ import annotations

import torch


def rms_init(d: int, dtype=torch.float32, device="cuda"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_apply(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (y * params["scale"].float()).to(x.dtype)


def ln_apply(params, x, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def group_norm_heads(x, n_heads: int, eps: float = 1e-5):
    """GroupNorm over head groups for the RWKV6 output (no learned affine;
    the caller keeps eps at 1e-5, as the reference does)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, n_heads, d // n_heads).float()
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xh - mu), dim=-1, keepdim=True)
    y = (xh - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return y.reshape(b, s, d).to(x.dtype)
