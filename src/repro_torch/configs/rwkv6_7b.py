"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536. "Finch": data-dependent decay.  [arXiv:2404.05892]

The port's copy of the reference configuration (without the registry).
Callers cut depth with ``dataclasses.replace``.
"""
from repro_torch.common.types import ModelConfig

CFG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern=("rwkv6",),
    rwkv_head_dim=64,
    use_rope=False,
)
