"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (W=4096).
[arXiv:2401.04088]"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    layer_pattern=("attention",),
    ffn_pattern=("moe",),
    n_experts=8,
    top_k=2,
    activation="swiglu",
    attention_kind="sliding",
    window_size=4096,
    rope_theta=1_000_000.0,
)

SPEC = register(ArchSpec(
    arch_id="mixtral-8x7b",
    desc=CFG,
    citation="arXiv:2401.04088 (Mixtral of Experts)",
    notes="Native sliding-window attention -> long_500k runs with a "
          "ring-buffer KV cache of W=4096. 8 experts < 16-wide model axis: "
          "expert weights shard on the FFN dim (see DESIGN.md).",
))
