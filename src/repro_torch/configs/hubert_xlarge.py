"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504,
encoder-only (wav2vec2-style backbone).  [arXiv:2106.07447]

Modality-frontend carve-out: the mel/conv feature extractor is a STUB —
``input_specs`` supplies 512-dim frame embeddings; this config implements the
transformer backbone + masked-prediction head (504 codebook units).
"""
from repro_torch.common.types import ModelConfig
from repro_torch.configs.common import ArchSpec, register

FRAME_EMBED_DIM = 512     # conv feature extractor output (stubbed)

CFG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,                 # HuBERT codebook units
    causal=False,                   # bidirectional encoder
    use_rope=False,                 # conv positional embedding (stubbed)
    activation="gelu",
    input_embed_dim=FRAME_EMBED_DIM,
    tie_embeddings=False,
)

SPEC = register(ArchSpec(
    arch_id="hubert-xlarge",
    desc=CFG,
    citation="arXiv:2106.07447 (HuBERT)",
    notes="Encoder-only: no decode step — decode_32k and long_500k are "
          "documented skips (DESIGN.md §4). train_4k = masked prediction "
          "over 4k frames; prefill_32k = pure encoding forward. Also serves "
          "as the audio-encoder stage of the Qwen2-Audio-style MLLM (Fig. 9).",
))
