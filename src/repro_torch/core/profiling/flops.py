"""Analytic FLOP / byte counting per architecture family.

The Profiling Engine (§3.2.1) profiles *attention* and *linear* operations
separately: "Attention operations are dependent on individual sequence
lengths ... In contrast, linear operations depend on the hidden size and can
be applied to the entire concatenated sequence at once."  We therefore split
every count into ``attn`` (per-instance-quadratic or recurrent) and ``lin``
(per-token linear) components.

All counts are *forward* FLOPs; training multiplies by 3 (backward ≈ 2×).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.common.types import FFNKind, LayerKind, ModelConfig

TRAIN_MULT = 3.0  # fwd + bwd(2x)


@dataclass(frozen=True)
class FlopCount:
    attn: float   # sequence-mixing FLOPs (quadratic / recurrent part)
    lin: float    # linear-layer FLOPs (projections, FFN, embed head)

    @property
    def total(self) -> float:
        return self.attn + self.lin

    def __add__(self, other: "FlopCount") -> "FlopCount":
        return FlopCount(self.attn + other.attn, self.lin + other.lin)

    def scale(self, s: float) -> "FlopCount":
        return FlopCount(self.attn * s, self.lin * s)


ZERO = FlopCount(0.0, 0.0)


def _attn_layer(cfg: ModelConfig, b: float, s: float, kv_len: float,
                causal: bool) -> FlopCount:
    h, kh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    proj = 2.0 * b * s * d * (h + 2 * kh) * hd + 2.0 * b * s * h * hd * d
    if cfg.attention_kind == "sliding" and cfg.window_size:
        eff_kv = min(kv_len, cfg.window_size)
    else:
        eff_kv = kv_len
    score_av = 2.0 * 2.0 * b * s * eff_kv * h * hd
    if causal and s == kv_len and cfg.attention_kind != "sliding":
        score_av *= 0.5  # only the causal half is useful work
    return FlopCount(attn=score_av, lin=proj)


def _mamba_layer(cfg: ModelConfig, b: float, s: float) -> FlopCount:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_d_state
    R = max(1, -(-d // 16))
    lin = 2.0 * b * s * d * 2 * di          # in_proj
    lin += 2.0 * b * s * di * cfg.ssm_d_conv
    lin += 2.0 * b * s * di * (R + 2 * N)   # x_proj
    lin += 2.0 * b * s * R * di             # dt_proj
    lin += 2.0 * b * s * di * d             # out_proj
    attn = 6.0 * b * s * di * N             # selective scan
    return FlopCount(attn=attn, lin=lin)


def _rwkv_layer(cfg: ModelConfig, b: float, s: float) -> FlopCount:
    d, ff, m = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    lin = 2.0 * b * s * d * d * 5           # r,k,v,g,o
    lin += 2.0 * b * s * d * 5 * 32 * 2     # ddlerp lora
    lin += 2.0 * b * s * d * 64 * 2         # decay lora
    lin += 2.0 * b * s * (d * ff + ff * d + d * d)  # channel mix (+gate)
    attn = 6.0 * b * s * d * m              # wkv recurrence (state d x m)
    return FlopCount(attn=attn, lin=lin)


def _ffn_layer(cfg: ModelConfig, b: float, s: float, kind: FFNKind) -> FlopCount:
    d, ff = cfg.d_model, cfg.d_ff
    n_mat = 3 if cfg.activation in ("swiglu", "geglu") else 2
    if kind == FFNKind.MOE:
        lin = 2.0 * b * s * cfg.top_k * n_mat * d * ff
        lin += 2.0 * b * s * d * cfg.n_experts       # router
    else:
        lin = 2.0 * b * s * n_mat * d * ff
    return FlopCount(attn=0.0, lin=lin)


def module_flops(cfg: ModelConfig, batch: float, seq: float, *,
                 mode: str = "prefill", cache_len: float = 0.0) -> FlopCount:
    """Forward FLOPs for one step of the module.

    mode:
      train/prefill — process `seq` tokens (kv_len = seq)
      decode        — one new token against a cache of `cache_len`
    """
    if mode == "decode":
        s, kv = 1.0, max(1.0, cache_len)
    else:
        s, kv = float(seq), float(seq)
    b = float(batch)

    total = ZERO
    for lk, fk in zip(cfg.layer_kinds, cfg.ffn_kinds):
        if lk == LayerKind.ATTENTION:
            total = total + _attn_layer(cfg, b, s, kv, cfg.causal)
            total = total + _ffn_layer(cfg, b, s, fk)
        elif lk == LayerKind.MAMBA:
            total = total + _mamba_layer(cfg, b, s)
            total = total + _ffn_layer(cfg, b, s, fk)
        elif lk == LayerKind.RWKV6:
            total = total + _rwkv_layer(cfg, b, s)
    if cfg.has_lm_head and cfg.vocab_size:
        total = total + FlopCount(0.0, 2.0 * b * s * cfg.d_model * cfg.vocab_size)
    if mode == "train":
        total = total.scale(TRAIN_MULT)
    return total


def module_param_bytes(cfg: ModelConfig, bytes_per_param: int = 2) -> float:
    return float(cfg.param_count()) * bytes_per_param


def model_flops_6nd(cfg: ModelConfig, tokens: float) -> float:
    """The standard 6·N·D estimate (N = active params) for §Roofline."""
    return 6.0 * cfg.active_param_count() * tokens
