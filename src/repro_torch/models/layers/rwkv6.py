"""RWKV-6 "Finch" block: data-dependent-decay linear attention + channel mix
(the train branch of the reference layer; no decode cache).

Time mixing (per head, head_dim M):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: M x M)
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with per-channel decay w_t = exp(-exp(decay + lora(x'_t))).

Implementations of the WKV recurrence, chosen by ``impl``:

  * ``naive``  — ``wkv_scan_xla``, a Python loop over time that autograd
                 differentiates (the reference's XLA scan);
  * ``kernel`` — the WKV6 kernels K6/K7 (``kernels/rwkv6_scan.py``): CUDA on
                 a CUDA tensor, their plain versions on a CPU tensor.

Token shift and the recurrent state run across packed segment boundaries,
as in the reference (``segment_ids`` is not read).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers.norms import group_norm_heads

LORA_RANK = 32
DECAY_LORA_RANK = 64
MIX_NAMES = ("w", "k", "v", "r", "g")
IMPLS = ("naive", "kernel")


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init(gen, cfg: ModelConfig, dtype=torch.float32):
    d, ff = cfg.d_model, cfg.d_ff
    h, m = n_heads(cfg), cfg.rwkv_head_dim
    dev = gen.device

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    s = d ** -0.5
    return {
        "wr": normal((d, d), s), "wk": normal((d, d), s), "wv": normal((d, d), s),
        "wg": normal((d, d), s), "wo": normal((d, d), s),
        # DDLerp: base mixes + shared rank-32 lora over the 5 targets
        "mix_base": torch.full((5, d), 0.5, dtype=dtype, device=dev),
        "mix_x": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "lora_a": normal((d, 5, LORA_RANK), s),
        "lora_b": normal((5, LORA_RANK, d), LORA_RANK ** -0.5),
        # data-dependent decay
        "decay_base": torch.linspace(-6.0, -1.0, d, device=dev).to(dtype),
        "decay_lora_a": normal((d, DECAY_LORA_RANK), s),
        "decay_lora_b": normal((DECAY_LORA_RANK, d), DECAY_LORA_RANK ** -0.5),
        "time_first": normal((h, m), 0.1),
        # channel mixing
        "cm_mix": torch.full((2, d), 0.5, dtype=dtype, device=dev),
        "cm_wk": normal((d, ff), s),
        "cm_wv": normal((ff, d), ff ** -0.5),
        "cm_wr": normal((d, d), s),
    }


def _shift(x, prev):
    """Token shift: x_{t-1}, with `prev` as the t=-1 row. x: (B,S,d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _ddlerp(params, x, xprev):
    """Data-dependent interpolation -> five mixed inputs (B,S,5,d)."""
    dx = xprev - x
    xx = x + dx * params["mix_x"].to(x.dtype)
    a = torch.tanh(torch.einsum("bsd,dfr->bsfr", xx, params["lora_a"].to(x.dtype)))
    offs = torch.einsum("bsfr,frd->bsfd", a, params["lora_b"].to(x.dtype))
    mix = params["mix_base"].to(x.dtype)[None, None] + offs
    return x[:, :, None] + dx[:, :, None] * mix


def wkv_scan_xla(r, k, v, w, u, state0=None):
    """Sequential WKV6 recurrence (the naive path).

    r,k,v,w: (B, S, H, M); u: (H, M).  Returns y: (B,S,H,M) f32 and the final
    state (B,H,M,M), indexed [key_dim, value_dim]."""
    B, S, H, M = r.shape
    s = state0 if state0 is not None else torch.zeros(
        (B, H, M, M), dtype=torch.float32, device=r.device)
    u32 = u.float()[None, :, :, None]
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkm->bhm", rf[:, t], s + u32 * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1), s


def time_mix(params, x, cfg: ModelConfig, *, impl: str = "kernel"):
    """RWKV6 attention replacement. x: (B,S,d) -> (B,S,d)."""
    B, S, d = x.shape
    h, m = n_heads(cfg), cfg.rwkv_head_dim
    xprev = _shift(x, torch.zeros((B, d), dtype=x.dtype, device=x.device))
    mixed = _ddlerp(params, x, xprev)                        # (B,S,5,d)
    x_w, x_k, x_v, x_r, x_g = (mixed[:, :, i] for i in range(5))

    r = x_r @ params["wr"].to(x.dtype)
    k = x_k @ params["wk"].to(x.dtype)
    v = x_v @ params["wv"].to(x.dtype)
    g = F.silu(x_g @ params["wg"].to(x.dtype))

    dlo = torch.tanh(x_w @ params["decay_lora_a"].to(x.dtype))
    dec = params["decay_base"].float() + (
        dlo @ params["decay_lora_b"].to(x.dtype)).float()
    w = torch.exp(-torch.exp(dec))                           # (B,S,d) in (0,1), f32

    rh, kh, vh, wh = (t.reshape(B, S, h, m) for t in (r, k, v, w))
    if impl == "kernel":
        y, _ = kops.rwkv6_scan(rh, kh, vh, wh, params["time_first"])
    elif impl == "naive":
        y, _ = wkv_scan_xla(rh, kh, vh, wh, params["time_first"])
    else:
        raise ValueError(f"WKV impl {impl!r} not in {IMPLS}")
    y = y.reshape(B, S, d).to(x.dtype)
    y = group_norm_heads(y, h) * g
    return y @ params["wo"].to(x.dtype)


def channel_mix(params, x, cfg: ModelConfig):
    """RWKV squared-relu channel mixing with token shift."""
    B, S, d = x.shape
    xprev = _shift(x, torch.zeros((B, d), dtype=x.dtype, device=x.device))
    mk = params["cm_mix"][0].to(x.dtype)
    mr = params["cm_mix"][1].to(x.dtype)
    xk = x + (xprev - x) * mk
    xr = x + (xprev - x) * mr
    kk = torch.square(F.relu(xk @ params["cm_wk"].to(x.dtype)))
    out = kk @ params["cm_wv"].to(x.dtype)
    return out * torch.sigmoid(xr @ params["cm_wr"].to(x.dtype))
