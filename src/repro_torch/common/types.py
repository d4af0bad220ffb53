"""Configuration types of the port: the fields and properties of
``ModelConfig`` / ``MLLMConfig`` that the training slice reads, with the same
names and defaults as the reference, plus the device and dtype helpers that
every entry point uses."""
from __future__ import annotations

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


class FFNKind(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"


@dataclass(frozen=True)
class ModelConfig:
    """One transformer stack (decoder LLM or encoder)."""

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
    def block_period(self) -> int:
        """Smallest tiling period of (layer_pattern, ffn_pattern)."""
        a, b = len(self.layer_pattern), len(self.ffn_pattern)
        period = a * b // math.gcd(a, b)
        return period if self.n_layers % period == 0 else self.n_layers


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
