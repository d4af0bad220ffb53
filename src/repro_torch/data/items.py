"""Data item abstraction: the unit the Online Microbatch Scheduler balances.

A training instance is characterized (for scheduling purposes) by the two
shape dimensions the paper identifies (§3.2.2):
  * the encoder's effective batch contribution  b(d) = number of media items
    (images / video frames) — each media item is E_seq_len encoder tokens;
  * the LLM's sequence-length contribution      s(d) = connector output
    tokens + text tokens (sequence packing makes the LLM batch 1).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DataItem:
    n_media_items: int          # images / sampled frames in the instance
    text_len: int               # text tokens
    modality: str = "single_image"
    item_id: int = -1

    def encoder_batch(self) -> int:
        return self.n_media_items

    def llm_seq_len(self, tokens_per_media_item: int) -> int:
        return self.n_media_items * tokens_per_media_item + self.text_len


def item_shapes(item: DataItem, tokens_per_media_item: int) -> tuple[int, int]:
    """(b(d), s(d)) — the two quantities DFLOP's models are keyed on."""
    return item.encoder_batch(), item.llm_seq_len(tokens_per_media_item)
