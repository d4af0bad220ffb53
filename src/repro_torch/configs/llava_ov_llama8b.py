"""LLaVA-OneVision (Llama-3 8B) — paper Table 3 / the Fig. 11–14 workhorse:
SigLIP encoder + Llama-3-8B backbone.  [arXiv:2408.03326, arXiv:2407.21783]
"""
from repro_torch.common.types import MLLMConfig, ModalityStub, ModelConfig
from repro_torch.configs.common import ArchSpec, register
from repro_torch.configs.llava_ov_qwen7b import ENCODER, LLM_TOKENS_PER_IMAGE, \
    PATCHES_PER_IMAGE, PATCH_EMBED_DIM
from repro_torch.common.types import ModalityStub

LLM = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    activation="swiglu",
    rope_theta=500_000.0,
)

CFG = MLLMConfig(
    name="llava-ov-llama8b",
    encoder=ENCODER,
    llm=LLM,
    stub=ModalityStub("vision", PATCHES_PER_IMAGE, PATCH_EMBED_DIM),
    connector_hidden=4096,
    tokens_per_item_out=LLM_TOKENS_PER_IMAGE,
)

SPEC = register(ArchSpec(
    arch_id="llava-ov-llama8b",
    desc=CFG,
    citation="arXiv:2408.03326 (LLaVA-OneVision) + arXiv:2407.21783 (Llama 3)",
    notes="Paper's micro-experiment configuration (Figs. 11-14).",
    tokens_per_media_item=LLM_TOKENS_PER_IMAGE,
))
