"""The benchmark's frozen arithmetic: the card's peaks, the model FLOPs of a
step, the least time K1-K3 could take on a packed row, and the union of the
device's busy intervals.  Later changes to the program cannot move these.

Peaks: one H100 SXM at its 700 W limit, NVIDIA's data sheet, dense rates:
989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s of HBM.
"""
from __future__ import annotations

import numpy as np

from portbench.dims import Dims

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def segment_lengths(seg_row) -> dict[int, int]:
    """Tokens of each segment id in one packed row (0: the padding)."""
    ids, counts = np.unique(np.asarray(seg_row), return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts)}


def kept_pairs(seg_row, *, real_only: bool) -> int:
    """Causal (q, k) pairs the packed mask keeps in one row: within a
    segment, key at or before the query.  Segments are contiguous, so a
    segment of n tokens keeps n(n+1)/2.  ``real_only`` leaves out the
    padding's segment (id 0), whose tokens attend one another."""
    return sum(n * (n + 1) // 2 for i, n in segment_lengths(seg_row).items()
               if i > 0 or not real_only)


def step_model_flops(m: Dims, segment_ids) -> float:
    """Model FLOPs of one training step over the real tokens of its rows
    (``segment_ids`` of any shape ending in the row): 6 per matmul
    parameter and token (forward and backward, LM head in, embedding lookup
    out) plus 3 x 4·hd·H per real kept (q, k) pair in each attention layer
    (QK^T and PV, forward and backward).  No recompute, no padding."""
    rows = np.asarray(segment_ids).reshape(-1, np.asarray(segment_ids).shape[-1])
    tokens = int((rows > 0).sum())
    pairs = sum(kept_pairs(r, real_only=True) for r in rows)
    return 6.0 * m.matmul_params * tokens + 12.0 * m.head_dim * m.heads * m.layers * pairs


def attention_launch_bounds(m: Dims, seg_row, elem_bytes: int = 2) -> dict[str, float]:
    """Least seconds of one launch of K1, K2 and K3 on one packed row:
    max(operations / peak, bytes / HBM rate), operations over the pairs the
    mask keeps (the padding attends itself, so its pairs count), each input
    byte read once and each output byte written once (``chip_smoke.py``'s
    ``[timing]`` arithmetic): K1 4·hd·H a pair (QK^T, PV), K2 1.5x, K3 2x."""
    S = len(seg_row)
    f = 4.0 * m.head_dim * m.heads * kept_pairs(seg_row, real_only=False)
    qb = m.heads * S * m.head_dim * elem_bytes
    kvb = m.kv_heads * S * m.head_dim * elem_bytes
    segb, rowb = S * 4, m.heads * S * 4
    work = {"K1": (f, qb + 2 * kvb + segb + qb + rowb),
            "K2": (1.5 * f, qb + 2 * kvb + segb + qb + 2 * rowb + qb),
            "K3": (2.0 * f, qb + 2 * kvb + segb + qb + 2 * rowb + 2 * kvb)}
    return {k: max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
            for k, (ops, nbytes) in work.items()}


def busy_union(spans, t0: float, t1: float) -> float:
    """Length of the union of the intervals ``spans`` clipped to [t0, t1]
    (``chip_smoke.py::profile_step``'s idle arithmetic)."""
    busy, end = 0.0, t0
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(spans, t0: float, t1: float) -> list[tuple[float, float]]:
    """The intervals of [t0, t1] that no span covers, in order."""
    gaps, end = [], t0
    for a, b in sorted((max(a, t0), min(b, t1)) for a, b in spans):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if t1 > end:
        gaps.append((end, t1))
    return gaps
