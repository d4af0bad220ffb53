"""The sizes of a decoder configuration file (``configs/<name>.json``, in the
keys of the model's published ``config.json``) as the harness uses them."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    rope_theta: float
    compute_dtype: str
    param_dtype: str

    @property
    def matmul_params(self) -> int:
        """Parameters of the matrix products a token passes through: the
        attention and SwiGLU projections of every layer and the LM head (the
        embedding is a lookup)."""
        attn = self.d * self.head_dim * (2 * self.heads + 2 * self.kv_heads)
        return self.layers * (attn + 3 * self.d * self.d_ff) + self.d * self.vocab


def dims(cfg: dict) -> Dims:
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("hidden_act", "silu") != "silu" or cfg.get("tie_word_embeddings"):
        raise ValueError(f"{cfg['name']}: the decoder driver runs SwiGLU with an untied head")
    return Dims(layers=cfg["num_hidden_layers"], d=d, heads=h,
                kv_heads=cfg["num_key_value_heads"], head_dim=cfg.get("head_dim", d // h),
                d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
                eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
                compute_dtype=cfg["torch_dtype"], param_dtype=cfg["param_dtype"])
