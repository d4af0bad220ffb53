"""Data Profiler (§3.2.2): empirical input-shape distribution of the dataset.

"The Data Profiler first identifies the varying input dimensions for both
the modality encoder and the LLM. It then performs random sampling across
the dataset, calculating the precise input shapes for each sampled item
within the target architecture to construct empirical histograms."

The model-specific transformation (media item -> connector tokens) is
captured by `tokens_per_media_item`, so the same dataset yields different
distributions per architecture — exactly the paper's point.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data.items import DataItem


@dataclass
class ShapeDistribution:
    """Per-item (b(d), s(d)) samples + histogram views."""

    enc_batches: np.ndarray     # (n,) encoder effective batch per item
    llm_seqs: np.ndarray        # (n,) LLM packed-seq contribution per item

    def mean(self) -> tuple[float, float]:
        return float(self.enc_batches.mean()), float(self.llm_seqs.mean())

    def histogram(self, which: str = "llm", bins: int = 32):
        data = self.llm_seqs if which == "llm" else self.enc_batches
        return np.histogram(data, bins=bins)

    def variance(self, which: str = "llm") -> float:
        data = self.llm_seqs if which == "llm" else self.enc_batches
        return float(np.var(data))

    def heterogeneity(self) -> float:
        """Coefficient of variation of the LLM seq-len (Fig. 11b proxy)."""
        return float(np.std(self.llm_seqs) / max(np.mean(self.llm_seqs), 1e-9))

    def __len__(self) -> int:
        return len(self.llm_seqs)


class DataProfiler:
    def __init__(self, tokens_per_media_item: int):
        self.tokens_per_media_item = tokens_per_media_item

    def shapes_of(self, item: DataItem) -> tuple[int, int]:
        return (item.encoder_batch(),
                item.llm_seq_len(self.tokens_per_media_item))

    def profile(self, items: Sequence[DataItem],
                n_samples: Optional[int] = None,
                seed: int = 0) -> ShapeDistribution:
        items = list(items)
        if n_samples is not None and n_samples < len(items):
            rng = np.random.default_rng(seed)
            idx = rng.choice(len(items), size=n_samples, replace=False)
            items = [items[i] for i in idx]
        shapes = np.array([self.shapes_of(it) for it in items], np.float64)
        if len(shapes) == 0:
            shapes = np.zeros((0, 2))
        return ShapeDistribution(shapes[:, 0], shapes[:, 1])

    def profile_sampler(self, dataset, n_samples: int = 2048) -> ShapeDistribution:
        """Sample from a MixedDataset-like object with .sample(n)."""
        return self.profile(dataset.sample(n_samples))
