"""Qwen2-Audio 7B — the paper's cross-modal generalization case (§5.3.1,
Fig. 9): Whisper-style audio encoder + Qwen2-7B backbone, with an average-
pooling connector that shrinks audio tokens before the LLM (the property the
paper credits for its balanced compute split).  [arXiv:2407.10759]
"""
from repro_torch.common.types import MLLMConfig, ModalityStub, ModelConfig
from repro_torch.configs.common import ArchSpec, register

FRAME_EMBED_DIM = 128               # mel filterbank frames (stubbed frontend)
FRAMES_PER_CLIP = 1500              # 30 s @ 50 Hz after conv
LLM_TOKENS_PER_CLIP = 375           # 4x average pooling

ENCODER = ModelConfig(
    name="qwen2-audio-encoder",
    family="audio-enc",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=0,
    causal=False,
    use_rope=False,
    activation="gelu",
    input_embed_dim=FRAME_EMBED_DIM,
    has_lm_head=False,
)

LLM = ModelConfig(
    name="qwen2-7b",
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
    name="qwen2-audio-7b",
    encoder=ENCODER,
    llm=LLM,
    stub=ModalityStub("audio", FRAMES_PER_CLIP, FRAME_EMBED_DIM),
    connector_hidden=0,
    tokens_per_item_out=LLM_TOKENS_PER_CLIP,
)

SPEC = register(ArchSpec(
    arch_id="qwen2-audio-7b",
    desc=CFG,
    citation="arXiv:2407.10759 (Qwen2-Audio)",
    notes="Audio MLLM for the Fig. 9 generalization benchmark; the 4x pooled "
          "connector balances encoder/LLM compute.",
    tokens_per_media_item=LLM_TOKENS_PER_CLIP,
))
