"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                    # per-expert FFN width
    vocab_size=49155,
    layer_pattern=("attention",),
    ffn_pattern=("moe",),
    n_experts=40,
    top_k=8,
    activation="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SPEC = register(ArchSpec(
    arch_id="granite-moe-3b-a800m",
    desc=CFG,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="Fine-grained MoE: 40 small experts, top-8 routing, every layer MoE. "
          "40 experts do not divide the 16-wide model axis, so expert "
          "parallelism falls back to FFN-dim sharding (see DESIGN.md).",
))
