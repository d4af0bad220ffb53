"""llava-ov-qwen7b [vlm] — LLaVA-OneVision with Qwen2.5-7B, the paper's primary
evaluated MLLM (Table 3): SigLIP-SO400M encoder (27L d_model=1152 16H, head
dim 72) + Qwen2.5-7B backbone (28L d_model=3584 28H, GQA kv=4, head dim 128,
d_ff=18944, vocab=152064).  [arXiv:2408.03326 (LLaVA-OneVision) +
arXiv:2412.15115 (Qwen2.5)]

The port's copy of the reference configuration.  The SigLIP patchifier is a
stub (the batch supplies 1152-dim patch embeddings); the SigLIP transformer
and the Qwen2.5 backbone are implemented.  LLaVA-OV's bilinear pool reduces
each image's 729 patches to 196 LLM tokens — the connector's mean-pool over
the media window.
"""
from repro_torch.common.types import MLLMConfig, ModalityStub, ModelConfig
from repro_torch.configs.common import ArchSpec, register

PATCH_EMBED_DIM = 1152              # SigLIP patch embedding (stubbed patchifier)
PATCHES_PER_IMAGE = 729             # 384/14 = 27x27
LLM_TOKENS_PER_IMAGE = 196          # LLaVA-OV bilinear pool per tile/frame

ENCODER = ModelConfig(
    name="siglip-so400m",
    family="vlm-enc",
    n_layers=27,
    d_model=1152,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4304,
    vocab_size=0,
    causal=False,
    use_rope=False,
    activation="gelu",
    input_embed_dim=PATCH_EMBED_DIM,
    has_lm_head=False,
)

LLM = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    activation="swiglu",
    rope_theta=1_000_000.0,
)

CFG = MLLMConfig(
    name="llava-ov-qwen7b",
    encoder=ENCODER,
    llm=LLM,
    stub=ModalityStub("vision", PATCHES_PER_IMAGE, PATCH_EMBED_DIM),
    connector_hidden=3584,
    tokens_per_item_out=LLM_TOKENS_PER_IMAGE,
)

SPEC = register(ArchSpec(
    arch_id="llava-ov-qwen7b",
    desc=CFG,
    citation="arXiv:2408.03326 (LLaVA-OneVision) + arXiv:2412.15115 (Qwen2.5)",
    notes="Paper Table 3 configuration; used by the Fig. 7/10/13 benchmarks.",
    tokens_per_media_item=LLM_TOKENS_PER_IMAGE,
))
