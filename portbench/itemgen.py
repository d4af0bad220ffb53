"""The general generator of training items: reads a traffic mix's parameters
(``traffic/<mix>.json``) and yields each step's items.

An item is a multimodal sample as the scheduler sees it: a number of media
items (images or frames) and a number of text tokens.  Its LLM sequence is
``media * tokens_per_media_item + text`` tokens (the connector's output plus
the text), as ``repro_torch.data.items.DataItem.llm_seq_len`` counts it.

The sizes of every step come from the mix's ``pool_seed`` alone, so every
run seed trains the same sequence of step compositions; the run seed only
permutes the items inside each step (and, elsewhere, draws the weights and
the token ids).  Step ``k`` draws ``items_per_step`` items: a modality by
the mix's weights, then media and text counts uniform over the modality's
inclusive ranges (``MixedDataset.sample``'s rule).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PROFILE_STREAM = 2 ** 32      # the stream of the items the planner profiles


@dataclass(frozen=True)
class Item:
    n_media: int
    text: int
    modality: str
    item_id: int

    def llm_len(self, tokens_per_media_item: int) -> int:
        return self.n_media * tokens_per_media_item + self.text


def _draw(traffic: dict, rng: np.random.Generator, n: int, first_id: int) -> list[Item]:
    names = sorted(traffic["mixture"])
    probs = np.array([traffic["mixture"][k] for k in names], np.float64)
    probs = probs / probs.sum()
    kinds = rng.choice(len(names), size=n, p=probs)
    out = []
    for j, k in enumerate(kinds):
        prof = traffic["profiles"][names[k]]
        lo, hi = prof["media"]
        media = int(rng.integers(lo, hi + 1)) if hi else 0
        tlo, thi = prof["text"]
        text = int(rng.integers(tlo, thi + 1))
        out.append(Item(media, text, names[k], first_id + j))
    return out


def step_items(traffic: dict, step: int, seed: int) -> list[Item]:
    """Step ``step``'s items: the composition of the mix's pool, in the
    order the run seed gives it."""
    n = traffic["items_per_step"]
    items = _draw(traffic, np.random.default_rng([traffic["pool_seed"], step]), n,
                  step * n)
    order = np.random.default_rng([abs(int(seed)), step, 7]).permutation(n)
    return [items[i] for i in order]


def profile_items(traffic: dict) -> list[Item]:
    """The items the Data Profiler sees before planning (fixed by the mix)."""
    return _draw(traffic, np.random.default_rng([traffic["pool_seed"], PROFILE_STREAM]),
                 traffic["profile_items"], -traffic["profile_items"])


class StepStream:
    """Each step's items in turn, keeping what it handed out (``drawn``)."""

    def __init__(self, traffic: dict, seed: int, to_item=lambda it: it):
        self.traffic, self.seed, self.to_item = traffic, seed, to_item
        self.drawn: list[list[Item]] = []

    def __iter__(self):
        return self

    def __next__(self):
        items = step_items(self.traffic, len(self.drawn), self.seed)
        self.drawn.append(items)
        return [self.to_item(it) for it in items]
