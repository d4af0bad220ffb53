"""Architecture registry: ArchSpec + shape-support rules (the port's copy of
the reference's ``configs/common.py``; only the imports differ)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

from repro_torch.common.types import (
    INPUT_SHAPES,
    MLLMConfig,
    ModalityStub,
    ModelConfig,
    ShapeSpec,
    reduced,
)

ModelDesc = Union[ModelConfig, MLLMConfig]


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    desc: ModelDesc
    citation: str
    notes: str = ""
    tokens_per_media_item: int = 0     # connector output tokens per media item

    @property
    def is_mllm(self) -> bool:
        return isinstance(self.desc, MLLMConfig)

    @property
    def llm_cfg(self) -> ModelConfig:
        return self.desc.llm if self.is_mllm else self.desc

    def reduced_desc(self) -> ModelDesc:
        if self.is_mllm:
            m: MLLMConfig = self.desc
            return dataclasses.replace(
                m,
                name=m.name + "-smoke",
                encoder=reduced(m.encoder, input_embed_dim=min(
                    64, m.encoder.input_embed_dim or 64)),
                llm=reduced(m.llm),
                stub=ModalityStub(m.stub.modality, min(m.stub.n_tokens, 16),
                                  min(m.stub.embed_dim, 64)),
                connector_hidden=min(m.connector_hidden, 64)
                if m.connector_hidden else 0,
                tokens_per_item_out=min(m.tokens_per_item_out, 8)
                if m.tokens_per_item_out else 0,
            )
        return reduced(self.desc)

    # ------------------------------------------------------------------ #
    def shape_support(self, shape: ShapeSpec) -> str:
        """'train' | 'prefill' | 'decode' | 'skip: <reason>'."""
        cfg = self.llm_cfg
        encoder_only = not cfg.is_decoder
        if shape.kind == "train":
            return "train"
        if shape.kind == "prefill":
            return "prefill"
        # decode shapes
        if encoder_only:
            return "skip: encoder-only architecture has no decode step"
        if shape.name == "long_500k" and not cfg.supports_long_context:
            return ("skip: pure full-attention architecture; 500k context "
                    "requires sub-quadratic sequence mixing")
        return "decode"

    def supported_shapes(self) -> Dict[str, str]:
        return {name: self.shape_support(spec)
                for name, spec in INPUT_SHAPES.items()}


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_config(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'. known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs(assigned_only: bool = False) -> list[str]:
    _ensure_loaded()
    if assigned_only:
        return [a for a in sorted(_REGISTRY) if a in ASSIGNED]
    return sorted(_REGISTRY)


ASSIGNED = (
    "granite-moe-3b-a800m", "rwkv6-7b", "deepseek-7b", "hubert-xlarge",
    "phi4-mini-3.8b", "jamba-v0.1-52b", "starcoder2-15b", "gemma-2b",
    "internvl2-2b", "mixtral-8x7b",
)

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib

    modules = [a.replace("-", "_").replace(".", "_") for a in ASSIGNED]
    modules += ["llava_ov_qwen7b", "llava_ov_llama8b", "qwen2_audio_7b"]
    for m in modules:
        importlib.import_module(f"repro_torch.configs.{m}")
