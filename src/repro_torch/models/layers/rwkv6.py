"""RWKV-6 "Finch" block: data-dependent-decay linear attention + channel mix.

Time mixing (per head, head_dim M):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: M x M)
    y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
with per-channel decay w_t = exp(-exp(decay + lora(x'_t))).

Implementations of the WKV recurrence, chosen by ``impl``:

  * ``naive``  — ``wkv_scan_xla``, a Python loop over time that autograd
                 differentiates (the reference's XLA scan);
  * ``kernel`` — the WKV6 kernels K6/K7 (``kernels/rwkv6_scan.py``): CUDA on
                 a CUDA tensor, their plain versions on a CPU tensor;
  * ``chunked`` — ``wkv_chunked``, the reference's closed-form chunked XLA
                 form in plain PyTorch.

With a cache (token shifts and the WKV state carried across calls) the
kernel path is not taken, as in the reference: ``kernel`` runs the serial
scan from the cached state, ``chunked`` the chunked form.

Token shift and the recurrent state run across packed segment boundaries,
as in the reference (``segment_ids`` is not read).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers.norms import group_norm_heads
from repro_torch.sharding.local import is_dtensor, rows_local

LORA_RANK = 32
DECAY_LORA_RANK = 64
MIX_NAMES = ("w", "k", "v", "r", "g")
IMPLS = ("naive", "kernel", "chunked")


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


def _log_decay(params, x_w):
    """log w_t = -exp(decay + lora(x_w)), f32 (B, S, d)."""
    dlo = torch.tanh(x_w @ params["decay_lora_a"].to(x_w.dtype))
    dec = params["decay_base"].float() + (
        dlo @ params["decay_lora_b"].to(x_w.dtype)).float()
    return -torch.exp(dec)


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


def wkv_chunked(r, k, v, logw, u, *, chunk: int = 32, state0=None):
    """Chunked (FLA-style) WKV6: sequential only across chunks.

    Within a chunk the recurrence is evaluated in closed form —
        y_t = (r_t ⊙ e^{P_t}) S_0  +  Σ_{j<t} Σ_m r_tm k_jm e^{P_tm − L_jm} v_j
              + (r_t ⊙ u ⊙ k_t) · v_t
    with L_t = Σ_{s≤t} log w_s and P_t = L_{t−1}; every exponent is ≤ 0.
    The chunk is the largest divisor of S not above ``chunk``.

    r,k,v,logw: (B, S, H, M); u: (H, M).  Returns (y f32, final state)."""
    B, S, H, M = r.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    n = S // c

    def to_chunks(t):
        return t.float().reshape(B, n, c, H, M).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, logw))      # (n,B,H,c,M)
    u32 = u.float()
    s = state0 if state0 is not None else torch.zeros(
        (B, H, M, M), dtype=torch.float32, device=r.device)
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)  # j < t
    ys = []
    for r_, k_, v_, lw_ in zip(rc, kc, vc, lwc):           # (B,H,c,M)
        L = torch.cumsum(lw_, dim=2)                       # L_t
        P = L - lw_                                        # L_{t-1}
        # inter-chunk
        y = torch.einsum("bhtm,bhmn->bhtn", r_ * torch.exp(P), s)
        # intra-chunk: E_{tjm} = exp(P_t - L_j), masked to j < t
        E = torch.exp(P[:, :, :, None, :] - L[:, :, None, :, :])
        E = torch.where(tri[None, None, :, :, None], E, 0.0)
        A = torch.einsum("bhtm,bhjm,bhtjm->bhtj", r_, k_, E)
        y = y + torch.einsum("bhtj,bhjn->bhtn", A, v_)
        # current-token bonus
        diag = torch.sum(r_ * k_ * u32[None, :, None, :], dim=-1)
        ys.append(y + diag[..., None] * v_)
        # state hand-off: S' = e^{L_c} ⊙ S0 + Σ_j (k_j e^{L_c - L_j}) v_j^T
        Lc = L[:, :, -1:, :]                               # (B,H,1,M)
        s = torch.exp(Lc[:, :, 0, :, None]) * s + torch.einsum(
            "bhjm,bhjn->bhmn", k_ * torch.exp(Lc - L), v_)
    y = torch.stack(ys, 0).permute(1, 0, 3, 2, 4).reshape(B, S, H, M)
    return y, s


def init_cache(cfg: ModelConfig, batch: int, device="cuda"):
    d = cfg.d_model
    h, m = n_heads(cfg), cfg.rwkv_head_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)  # noqa: E731
    return {"tm_prev": zeros(batch, d), "cm_prev": zeros(batch, d),
            "wkv": zeros(batch, h, m, m)}


def time_mix(params, x, cfg: ModelConfig, *, cache=None, impl: str = "kernel"):
    """RWKV6 attention replacement. x: (B,S,d) -> (B,S,d); with the layer's
    cache -> ((B,S,d), the cache), its token shift and state written in
    place."""
    B, S, d = x.shape
    h, m = n_heads(cfg), cfg.rwkv_head_dim
    prev = cache["tm_prev"].to(x.dtype) if cache is not None \
        else torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xprev = _shift(x, prev)
    if is_dtensor(x):
        # the data-dependent mixes on each rank's rows (DTensor's own rules
        # carry the low-rank products into strided shards it cannot multiply)
        lerp = ("mix_x", "lora_a", "lora_b", "mix_base")
        mixed = rows_local(lambda x, xp, *w: _ddlerp(dict(zip(lerp, w)), x, xp),
                           (x, xprev), [params[n] for n in lerp], 4)
    else:
        mixed = _ddlerp(params, x, xprev)                    # (B,S,5,d)
    x_w, x_k, x_v, x_r, x_g = (mixed[:, :, i] for i in range(5))

    r = x_r @ params["wr"].to(x.dtype)
    k = x_k @ params["wk"].to(x.dtype)
    v = x_v @ params["wv"].to(x.dtype)
    g = F.silu(x_g @ params["wg"].to(x.dtype))

    decay = ("decay_base", "decay_lora_a", "decay_lora_b")
    if is_dtensor(x):
        logw = rows_local(lambda xw, *w: _log_decay(dict(zip(decay, w)), xw),
                          (x_w,), [params[n] for n in decay], 3)
    else:
        logw = _log_decay(params, x_w)                       # log of decay
    w = torch.exp(logw)                                      # (B,S,d) in (0,1), f32

    rh, kh, vh, wh = (t.reshape(B, S, h, m) for t in (r, k, v, w))
    state0 = cache["wkv"] if cache is not None else None
    if impl not in IMPLS:
        raise ValueError(f"WKV impl {impl!r} not in {IMPLS}")
    if impl == "kernel" and cache is None:
        y, s_final = kops.rwkv6_scan(rh, kh, vh, wh, params["time_first"])
    elif impl == "chunked":
        y, s_final = wkv_chunked(rh, kh, vh, logw.reshape(B, S, h, m),
                                 params["time_first"], state0=state0)
    elif state0 is not None and is_dtensor(state0):
        # the serial step on each rank's heads (DTensor has no rule for its
        # batched products over strided shards)
        y, s_final = kops.wkv_dtensor(wkv_scan_xla, rh, kh, vh, wh,
                                      params["time_first"], state0)
    else:
        y, s_final = wkv_scan_xla(rh, kh, vh, wh, params["time_first"], state0)
    y = y.reshape(B, S, d).to(x.dtype)
    y = group_norm_heads(y, h) * g
    out = y @ params["wo"].to(x.dtype)
    if cache is None:
        return out
    cache["tm_prev"].copy_(x[:, -1])
    cache["wkv"].copy_(s_final)
    return out, cache


def channel_mix(params, x, cfg: ModelConfig, *, cache=None):
    """RWKV squared-relu channel mixing with token shift; with the layer's
    cache -> (y, the cache), its token shift written in place."""
    B, S, d = x.shape
    prev = cache["cm_prev"].to(x.dtype) if cache is not None \
        else torch.zeros((B, d), dtype=x.dtype, device=x.device)
    xprev = _shift(x, prev)
    mk = params["cm_mix"][0].to(x.dtype)
    mr = params["cm_mix"][1].to(x.dtype)
    xk = x + (xprev - x) * mk
    xr = x + (xprev - x) * mr
    kk = torch.square(F.relu(xk @ params["cm_wk"].to(x.dtype)))
    out = kk @ params["cm_wv"].to(x.dtype)
    out = out * torch.sigmoid(xr @ params["cm_wr"].to(x.dtype))
    if cache is None:
        return out
    cache["cm_prev"].copy_(x[:, -1])
    return out, cache
