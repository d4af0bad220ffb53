"""Dense feed-forward blocks (SwiGLU / GeGLU / GELU / ReLU^2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig

GATED = ("swiglu", "geglu")


def _act(name: str, x):
    # jax.nn.gelu defaults to the tanh approximation
    if name == "swiglu":
        return F.silu(x)
    if name in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    if name == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def init(gen, cfg: ModelConfig, dtype=torch.float32):
    d, ff = cfg.d_model, cfg.d_ff

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype)

    p = {"w_up": normal((d, ff), d ** -0.5), "w_down": normal((ff, d), ff ** -0.5)}
    if cfg.activation in GATED:
        p["w_gate"] = normal((d, ff), d ** -0.5)
    return p


def apply(params, x, cfg: ModelConfig):
    up = x @ params["w_up"].to(x.dtype)
    if cfg.activation in GATED:
        gate = x @ params["w_gate"].to(x.dtype)
        h = _act(cfg.activation, gate) * up
    else:
        h = _act(cfg.activation, up)
    return h @ params["w_down"].to(x.dtype)
