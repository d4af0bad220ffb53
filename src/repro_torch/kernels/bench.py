"""Work counts for the kernels (copied from the reference's kernels/bench.py)."""
from __future__ import annotations


def attention_flops(B: int, H: int, S: int, D: int, *, causal: bool) -> float:
    """score + AV matmuls: 2·2·B·S·S·H·D, halved under causal masking."""
    f = 4.0 * B * S * S * H * D
    return f * 0.5 if causal else f
