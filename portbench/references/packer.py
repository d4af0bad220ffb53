"""The plain reference of the scheduled loader's output: which items a step
trains and how they are packed into rows.

Given a step's items and the scheduler's groups (the program's decision,
which this module judges), it checks that the groups cover every item of
the step exactly once, then packs each group as the loader promises:
group ``g`` is row ``g % dp`` of microbatch ``g // dp``; its items in group
order, each a sequence of ``min(len, budget)`` token ids drawn uniformly
from [2, vocab) by the loader's packing stream (numpy ``default_rng([seed,
1])``, one draw of each item's length in turn, group after group, step
after step); concatenated until the row is full, an item stopping the row
when it would place one token or none; labels the next token within the
item (-1 at its last token and on padding); segment ids 1, 2, .. (0 on
padding); positions restarting at each item.  Every token that does not
fit counts as truncated.  Plain numpy: nothing of the program.
"""
from __future__ import annotations

import numpy as np


class Packer:
    def __init__(self, seed: int, budget: int, vocab: int, tokens_per_media_item: int):
        self.rng = np.random.default_rng([seed, 1])
        self.budget, self.vocab, self.tpm = budget, vocab, tokens_per_media_item

    def row(self, lengths) -> tuple[dict, int]:
        S = self.budget
        row = {"tokens": np.zeros(S, np.int32), "labels": np.full(S, -1, np.int32),
               "segment_ids": np.zeros(S, np.int32), "positions": np.zeros(S, np.int32)}
        seqs = [self.rng.integers(2, max(3, self.vocab), size=min(n, S)) for n in lengths]
        cur = 0
        for s_idx, s in enumerate(seqs):
            take = min(len(s), S - cur)
            if take <= 1:
                break
            row["tokens"][cur:cur + take] = s[:take]
            row["labels"][cur:cur + take - 1] = s[1:take]
            row["segment_ids"][cur:cur + take] = s_idx + 1
            row["positions"][cur:cur + take] = np.arange(take)
            cur += take
        return row, int(sum(lengths)) - cur

    def step(self, items, groups, n_mb: int, dp: int) -> tuple[dict | None, int, str]:
        """(batch of (n_mb, dp, S) arrays, truncated tokens, fault or '')."""
        covered = sorted(j for g in groups for j in g)
        if len(groups) != n_mb * dp or covered != list(range(len(items))):
            return None, 0, f"groups {groups} do not cover the step's {len(items)} items once"
        out = {k: np.zeros((n_mb, dp, self.budget), np.int32)
               for k in ("tokens", "labels", "segment_ids", "positions")}
        out["labels"][:] = -1
        truncated = 0
        for g_idx, g in enumerate(groups):
            i, r = divmod(g_idx, dp)
            row, t = self.row([items[j].llm_len(self.tpm) for j in g])
            truncated += t
            for k, v in row.items():
                out[k][i, r] = v
        return out, truncated, ""


def mismatch(program: dict, reference: dict) -> str:
    """'' when the program's batch equals the reference's, else what differs."""
    bad = [k for k in reference if not np.array_equal(np.asarray(program[k]), reference[k])]
    return f"fields differ: {bad}" if bad else ""
