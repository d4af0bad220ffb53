"""deepseek-7b [dense] — 30L d_model=4096 32H (kv=32, MHA) d_ff=11008
vocab=102400, llama-arch.  [arXiv:2401.02954]"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

CFG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    activation="swiglu",
    rope_theta=10_000.0,
)

SPEC = register(ArchSpec(
    arch_id="deepseek-7b",
    desc=CFG,
    citation="arXiv:2401.02954 (DeepSeek LLM)",
    notes="Pure full attention: long_500k skipped (quadratic prefill; the "
          "source model has no sliding-window/sparse variant).",
))
