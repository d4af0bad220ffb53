"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA.  [arXiv:2412.08905]"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    activation="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SPEC = register(ArchSpec(
    arch_id="phi4-mini-3.8b",
    desc=CFG,
    citation="arXiv:2412.08905 (Phi-4)",
    notes="Large vocab (200k) makes the unembed matmul + vocab-sharded "
          "embedding a significant roofline term. long_500k skipped "
          "(full attention).",
))
