"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2, Mamba:attention 1:7 interleave.
[arXiv:2403.19887]

Layer structure (period 8, matching the paper's Jamba block): attention at
in-block index 4, Mamba elsewhere; MoE replaces the FFN on every other layer.

The port's copy of the reference configuration.  Callers cut depth with
``dataclasses.replace``.
"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attention", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe"),
    n_experts=16,
    top_k=2,
    activation="swiglu",
    use_rope=False,                  # Jamba attention layers use no RoPE
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
)

SPEC = register(ArchSpec(
    arch_id="jamba-v0.1-52b",
    desc=CFG,
    citation="arXiv:2403.19887 (Jamba)",
    notes="Hybrid: 4 attention layers of 32 -> decode state is Mamba states "
          "+ 4 KV caches; long_500k runs (sub-quadratic prefill dominated by "
          "Mamba scan; decode reads 4 x 500k KV). 16 experts divide the "
          "16-wide model axis -> true expert parallelism.",
))
