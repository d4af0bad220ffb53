"""Configuration types of the port: the fields and properties of
``ModelConfig`` / ``MLLMConfig`` that the models, the planner and the
architecture registry read (the parameter counts among them), the assigned
input shapes and ``reduced``, with the same names and defaults as the
reference, plus the device and dtype helpers that every entry point uses."""
from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass
from typing import Tuple

import torch


class LayerKind(str, enum.Enum):
    """Sequence-mixing block of a layer."""

    ATTENTION = "attention"
    MAMBA = "mamba"
    RWKV6 = "rwkv6"


class AttentionKind(str, enum.Enum):
    FULL = "full"            # full causal (or bidirectional for encoders)
    SLIDING = "sliding"      # sliding-window causal attention


class FFNKind(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"


# Fields the reference's ModelConfig does not have: at their defaults (off)
# the port computes what the reference does.
PORT_ONLY_FIELDS = ("ssm_segment_reset", "ssm_inner_norms")


@dataclass(frozen=True)
class ModelConfig:
    """One transformer stack (decoder LLM, encoder, or SSM/hybrid)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = ("attention",)
    attention_kind: str = "full"
    window_size: int = 0             # >0 with attention_kind == "sliding"
    causal: bool = True
    rope_theta: float = 10_000.0
    use_rope: bool = True
    activation: str = "swiglu"       # swiglu | geglu | gelu | relu_sq
    ffn_pattern: Tuple[str, ...] = ("dense",)
    n_experts: int = 0
    top_k: int = 0
    ssm_d_state: int = 16            # Mamba
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # Mamba on packed rows: restart the conv and the state at every segment
    # start (the reference runs across segments); Jamba's RMSNorms on dt's
    # low rank, B and C after x_proj (HF ``modeling_jamba``)
    ssm_segment_reset: bool = False
    ssm_inner_norms: bool = False
    rwkv_head_dim: int = 64          # RWKV6
    input_embed_dim: int = 0         # >0: consume precomputed embeddings via in_proj
    has_lm_head: bool = True
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    dtype: str = "bfloat16"          # activation / compute dtype
    param_dtype: str = "float32"
    remat: bool = True               # checkpoint each layer in training

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        pat = tuple(LayerKind(k) for k in self.layer_pattern)
        reps = math.ceil(self.n_layers / len(pat))
        return (pat * reps)[: self.n_layers]

    @property
    def ffn_kinds(self) -> Tuple[FFNKind, ...]:
        pat = tuple(FFNKind(k) for k in self.ffn_pattern)
        reps = math.ceil(self.n_layers / len(pat))
        return (pat * reps)[: self.n_layers]

    @property
    def is_attention_free(self) -> bool:
        return all(k != LayerKind.ATTENTION for k in self.layer_kinds)

    @property
    def block_period(self) -> int:
        """Smallest tiling period of (layer_pattern, ffn_pattern)."""
        a, b = len(self.layer_pattern), len(self.ffn_pattern)
        period = a * b // math.gcd(a, b)
        return period if self.n_layers % period == 0 else self.n_layers

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing (SSM / hybrid / sliding window)."""
        if self.is_attention_free:
            return True
        if any(k != LayerKind.ATTENTION for k in self.layer_kinds):
            return True  # hybrid
        return self.attention_kind == AttentionKind.SLIDING.value

    @property
    def is_decoder(self) -> bool:
        return self.causal

    # -- parameter counting (exact, mirrors init) ----------------------- #
    def param_count(self) -> int:
        d = self.d_model
        total = self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d                  # unembed
        total += d                                        # final norm
        for kind, ffn in zip(self.layer_kinds, self.ffn_kinds):
            total += 2 * d                                # two norms
            if kind == LayerKind.ATTENTION:
                hd = self.head_dim
                total += d * self.n_heads * hd            # wq
                total += 2 * d * self.n_kv_heads * hd     # wk, wv
                total += self.n_heads * hd * d            # wo
            elif kind == LayerKind.MAMBA:
                di = self.ssm_expand * d
                total += d * 2 * di                       # in_proj
                total += di * self.ssm_d_conv             # conv
                total += di * (2 * self.ssm_d_state + 1)  # x_proj(B,C,dt) low-rank part
                total += di + di                          # A_log (di x N folded), D  (approx: di*N)
                total += di * self.ssm_d_state            # A_log actual
                total += di * d                           # out_proj
                if self.ssm_inner_norms:                  # dt, B, C norm scales
                    total += math.ceil(d / 16) + 2 * self.ssm_d_state
            elif kind == LayerKind.RWKV6:
                h = d // self.rwkv_head_dim
                total += 5 * d * d                        # r,k,v,g,o projections
                total += 2 * d * 5 * 32                   # ddlerp lora a/b
                total += 2 * d * 64                       # decay lora a/b
                total += 5 * d + d + d + 2 * d            # mixes + decay_base
                total += h * self.rwkv_head_dim           # time_first (u)
                total += 2 * d * self.d_ff + d * d        # channel mix k,v,r
                continue                                  # rwkv has no extra FFN
            if ffn == FFNKind.MOE:
                n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
                total += self.n_experts * n_mat * d * self.d_ff
                total += d * self.n_experts               # router
            else:
                n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
                total += n_mat * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, n_mat = self.d_model, 3 if self.activation in ("swiglu", "geglu") else 2
        moe_layers = sum(1 for f in self.ffn_kinds if f == FFNKind.MOE)
        inactive = moe_layers * (self.n_experts - self.top_k) * n_mat * d * self.d_ff
        return self.param_count() - inactive


@dataclass(frozen=True)
class ModalityStub:
    """Stubbed modality frontend: the batch carries precomputed embeddings."""

    modality: str
    n_tokens: int
    embed_dim: int


@dataclass(frozen=True)
class MLLMConfig:
    """Encoder -> connector -> LLM composition (what DFLOP optimizes)."""

    name: str
    encoder: ModelConfig
    llm: ModelConfig
    stub: ModalityStub
    connector_hidden: int = 0        # 0 -> linear projector, else 2-layer MLP
    tokens_per_item_out: int = 0     # connector may downsample (0 -> keep)

    @property
    def vocab_size(self) -> int:
        return self.llm.vocab_size

    def param_count(self) -> int:
        total = self.encoder.param_count() + self.llm.param_count()
        de, dl = self.encoder.d_model, self.llm.d_model
        if self.connector_hidden:
            total += de * self.connector_hidden + self.connector_hidden * dl
        else:
            total += de * dl
        return total


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


INPUT_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, d<=512)."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32 if cfg.n_heads else 0
    n_heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    n_kv = max(1, min(cfg.n_kv_heads, n_heads)) if cfg.n_heads else 0
    period = len(cfg.layer_pattern)
    n_layers = min(cfg.n_layers, max(2, period)) if period > 2 else 2
    base = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        window_size=min(cfg.window_size, 64) if cfg.window_size else 0,
        rwkv_head_dim=32 if cfg.layer_pattern[0] == "rwkv6" else cfg.rwkv_head_dim,
        dtype="float32",
        param_dtype="float32",
    )
    return dataclasses.replace(base, **overrides) if overrides else base


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA without a card
    raises; nothing quietly runs on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
