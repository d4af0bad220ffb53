"""Sequence packing (paper §3.2.1): concatenate instances into one sequence.

"We employ sequence packing for the LLM to concatenate instances,
effectively fixing the batch size to 1 while making L_seq_len highly
variable."  Segment ids preserve per-instance causal integrity (consumed by
the packed flash-attention mask).  A copy of the reference's
``data/packing.py`` (``PackedBatch``, ``pack_tokens``, ``pack_items``,
``greedy_bin_pack``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.data.items import DataItem


@dataclass
class PackedBatch:
    """One packed microbatch: token budget `budget`, padded to it.

    Token accounting is conserved, never silent: every input token is
    either placed (``used``) or dropped at the budget boundary
    (``truncated``), and the row is padded back up to the budget
    (``padding``) — so ``used + truncated == Σ len(seq)`` and
    ``used + padding == budget``.
    """

    tokens: np.ndarray        # (1, budget) int32
    labels: np.ndarray        # (1, budget) int32, -1 = ignore
    segment_ids: np.ndarray   # (1, budget) int32, 0 = padding
    positions: np.ndarray     # (1, budget) int32, restart per segment
    n_items: int
    used: int
    truncated: int = 0        # input tokens dropped at the budget boundary

    @property
    def padding(self) -> int:
        return self.tokens.shape[-1] - self.used


def pack_tokens(sequences: Sequence[np.ndarray], budget: int,
                pad_id: int = 0) -> PackedBatch:
    """Pack token sequences into one row of `budget` tokens.  Overflow is
    truncated but *counted*: ``PackedBatch.truncated`` carries every dropped
    input token, including whole sequences skipped once the row is (nearly)
    full."""
    tokens = np.full((budget,), pad_id, np.int32)
    labels = np.full((budget,), -1, np.int32)
    seg = np.zeros((budget,), np.int32)
    pos = np.zeros((budget,), np.int32)
    total = sum(len(s) for s in sequences)
    cur = 0
    n = 0
    for s_idx, s in enumerate(sequences):
        s = np.asarray(s, np.int32)
        take = min(len(s), budget - cur)
        if take <= 1:
            break
        tokens[cur:cur + take] = s[:take]
        labels[cur:cur + take - 1] = s[1:take]
        seg[cur:cur + take] = s_idx + 1
        pos[cur:cur + take] = np.arange(take)
        cur += take
        n += 1
    return PackedBatch(tokens[None], labels[None], seg[None], pos[None], n,
                       cur, truncated=total - cur)


def pack_items(items: Sequence[DataItem], budget: int,
               tokens_per_media_item: int, vocab: int,
               rng: np.random.Generator) -> PackedBatch:
    """Pack DataItems (media tokens become placeholder token spans).

    Items longer than the whole budget are clipped *before* token
    generation, but the clipped length still counts toward
    ``PackedBatch.truncated`` so the accounting identity holds against the
    items' true lengths."""
    seqs = []
    pre_clipped = 0
    for it in items:
        full = it.llm_seq_len(tokens_per_media_item)
        L = min(full, budget)
        pre_clipped += full - L
        seqs.append(rng.integers(2, max(3, vocab), size=L))
    pb = pack_tokens(seqs, budget)
    pb.truncated += pre_clipped
    return pb


def greedy_bin_pack(lengths: Sequence[int], budget: int) -> List[List[int]]:
    """First-fit-decreasing packing of item lengths into budget-sized bins.
    Returns item-index groups (used by the data loader to build microbatch
    rows once the scheduler has fixed the groups)."""
    order = np.argsort(lengths)[::-1]
    bins: List[List[int]] = []
    space: List[int] = []
    for i in order:
        L = min(int(lengths[i]), budget)
        placed = False
        for b, s in enumerate(space):
            if s >= L:
                bins[b].append(int(i))
                space[b] -= L
                placed = True
                break
        if not placed:
            bins.append([int(i)])
            space.append(budget - L)
    return bins
