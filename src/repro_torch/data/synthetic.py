"""Synthetic multimodal datasets mirroring the paper's mixed workload (Table 2).

The paper's composite dataset mixes single-image (LLaVA-Wild / AI2D /
InfographicVQA), multi-image (M4-Instruct) and video (LLaVA-Video) items.
We reproduce its *shape statistics*: per-item media-item counts and text
lengths drawn from per-modality distributions, with the mixture weights of
Table 2 (65k / 60k / 60k -> 0.35 / 0.32 / 0.33).

`MixedDataset` yields `DataItem`s (for the scheduler) and can materialize
tensor batches (stub embeddings + token ids) for actual training.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.items import DataItem


@dataclass(frozen=True)
class ModalityProfile:
    name: str
    media_lo: int
    media_hi: int               # inclusive; uniform over [lo, hi]
    text_lo: int
    text_hi: int


# media counts: single image = 1 (hi-res tiling handled by tokens/item);
# M4-Instruct interleaves 2-8 images; video = 8-32 sampled frames.
PROFILES = {
    "single_image": ModalityProfile("single_image", 1, 1, 64, 1024),
    "multi_image": ModalityProfile("multi_image", 2, 8, 128, 1536),
    "video": ModalityProfile("video", 8, 32, 64, 768),
    "text": ModalityProfile("text", 0, 0, 256, 4096),
    "audio": ModalityProfile("audio", 1, 4, 64, 768),
}

MIXTURES: Dict[str, Dict[str, float]] = {
    # paper Table 2 composition
    "mixed": {"single_image": 0.35, "multi_image": 0.32, "video": 0.33},
    "multi_image": {"multi_image": 1.0},
    "video": {"video": 1.0},
    "single_image": {"single_image": 1.0},
    "audio": {"audio": 0.7, "text": 0.3},
    "text": {"text": 1.0},
}


class MixedDataset:
    """Infinite sampler of DataItems with a fixed modality mixture."""

    def __init__(self, mixture: str | Dict[str, float] = "mixed",
                 seed: int = 0, tokens_per_media_item: int = 196):
        self.mixture = MIXTURES[mixture] if isinstance(mixture, str) else mixture
        self.names = sorted(self.mixture)
        self.probs = np.array([self.mixture[n] for n in self.names])
        self.probs = self.probs / self.probs.sum()
        self.rng = np.random.default_rng(seed)
        self.tokens_per_media_item = tokens_per_media_item
        self._next_id = 0

    def sample(self, n: int) -> List[DataItem]:
        kinds = self.rng.choice(len(self.names), size=n, p=self.probs)
        items = []
        for k in kinds:
            prof = PROFILES[self.names[k]]
            media = int(self.rng.integers(prof.media_lo, prof.media_hi + 1)) \
                if prof.media_hi else 0
            text = int(self.rng.integers(prof.text_lo, prof.text_hi + 1))
            items.append(DataItem(media, text, self.names[k], self._next_id))
            self._next_id += 1
        return items

    def global_batches(self, gbs: int) -> Iterator[List[DataItem]]:
        while True:
            yield self.sample(gbs)

    # ------------------------------------------------------------------ #
    def materialize(self, items: Sequence[DataItem], *, embed_dim: int,
                    vocab_size: int, max_media: int, max_text: int,
                    seed: int = 0) -> dict:
        """Tensorize items into a padded multimodal batch (stub frontend)."""
        rng = np.random.default_rng(seed)
        B = len(items)
        t_media = max_media
        media = np.zeros((B, t_media, embed_dim), np.float32)
        media_mask = np.zeros((B, t_media), np.int32)
        text = np.zeros((B, max_text), np.int32)
        text_mask = np.zeros((B, max_text), np.int32)
        labels = np.full((B, max_text), -1, np.int32)
        tpm = self.tokens_per_media_item
        for i, it in enumerate(items):
            m = min(it.n_media_items * tpm, t_media)
            media[i, :m] = rng.standard_normal((m, embed_dim)) * 0.02
            media_mask[i, :m] = 1
            t = min(it.text_len, max_text)
            toks = rng.integers(1, vocab_size, size=t)
            text[i, :t] = toks
            text_mask[i, :t] = 1
            labels[i, : t - 1] = toks[1:]
        return {
            "media_embeds": media,
            "media_mask": media_mask,
            "text_tokens": text,
            "text_mask": text_mask,
            "labels": labels,
        }
