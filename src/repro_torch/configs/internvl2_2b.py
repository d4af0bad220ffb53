"""internvl2-2b [vlm] — InternViT encoder + InternLM2-1.8b backbone:
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  [arXiv:2404.16821]

The port's copy of the reference configuration.  The ViT patchifier is a
stub (the batch supplies 1024-dim patch embeddings); the InternViT-300M
transformer (24L d=1024) and the InternLM2 backbone are implemented.
InternVL's pixel-shuffle reduces 1024 patches/image to 256 LLM tokens — the
connector's downsample.
"""
from repro_torch.common.types import MLLMConfig, ModalityStub, ModelConfig
from repro_torch.configs.common import ArchSpec, register

PATCH_EMBED_DIM = 1024
PATCHES_PER_IMAGE = 1024            # 448x448 / 14 -> 32x32 patches
LLM_TOKENS_PER_IMAGE = 256          # pixel-shuffle 4x reduction

ENCODER = ModelConfig(
    name="internvit-300m",
    family="vlm-enc",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=0,
    causal=False,
    use_rope=False,
    activation="gelu",
    input_embed_dim=PATCH_EMBED_DIM,
    has_lm_head=False,
)

LLM = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    activation="swiglu",
    rope_theta=1_000_000.0,
)

CFG = MLLMConfig(
    name="internvl2-2b",
    encoder=ENCODER,
    llm=LLM,
    stub=ModalityStub("vision", PATCHES_PER_IMAGE, PATCH_EMBED_DIM),
    connector_hidden=2048,
    tokens_per_item_out=LLM_TOKENS_PER_IMAGE,
)

SPEC = register(ArchSpec(
    arch_id="internvl2-2b",
    desc=CFG,
    citation="arXiv:2404.16821 (InternVL 1.5/2)",
    notes="Full DFLOP applies: independent (tp, pp, dp) per module + "
          "inter-model communicator at the connector boundary. decode "
          "shapes exercise the LLM backbone; long_500k skipped (full "
          "attention).",
    tokens_per_media_item=LLM_TOKENS_PER_IMAGE,
))
