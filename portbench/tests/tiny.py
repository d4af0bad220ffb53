"""A tiny decoder and a short-row mix for the CPU tests: the harness's own
cells' files with the sizes cut so that a run takes seconds on the CPU."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import core  # noqa: E402

TINY = {"hidden_size": 256, "intermediate_size": 512, "num_attention_heads": 4,
        "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 256,
        "tokens_per_media_item": 8}


def cell(workload: str = "internlm2-1.8b.mixed", *, dtype: str = "bfloat16",
         budget: int = 256) -> dict:
    """``workload``'s cell with the tiny sizes, its own limits and mix."""
    c = core.cell(core.benchmark(), workload)
    c["config"] = {**c["config"], **TINY, "name": "tiny", "torch_dtype": dtype}
    c["traffic"] = {**c["traffic"], "token_budget": budget, "profile_items": 256}
    return c
