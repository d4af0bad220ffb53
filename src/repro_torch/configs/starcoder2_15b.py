"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GQA + RoPE.  [arXiv:2402.19173]"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    activation="gelu",              # StarCoder2 uses non-gated GELU MLP
    rope_theta=100_000.0,
)

SPEC = register(ArchSpec(
    arch_id="starcoder2-15b",
    desc=CFG,
    citation="arXiv:2402.19173 (StarCoder2)",
    notes="Largest dense assigned arch; kv=4 heads shard at most 4-way. "
          "long_500k skipped (the 15b variant is full-attention in the "
          "source release; 4k-window SWA exists only for 3b/7b).",
))
