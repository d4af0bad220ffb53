"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256.  [arXiv:2403.08295]"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,                   # MQA on the 2b variant
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SPEC = register(ArchSpec(
    arch_id="gemma-2b",
    desc=CFG,
    citation="arXiv:2403.08295 (Gemma)",
    notes="MQA: the single KV head replicates under TP (kv dim unshardable); "
          "decode is KV-bandwidth-light. 256k vocab dominates params (525M "
          "embed). long_500k skipped (full attention).",
))
