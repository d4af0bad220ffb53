"""Serving example: batched greedy decoding with decode caches across
families; the port's counterpart of the reference's ``examples/serve_decode.py``.

Runs a tiny dense (sliding-window) model, a tiny hybrid (Mamba + attention)
and a tiny RWKV6 model through incremental decoding
(``serve.steps.greedy_generate``: the prompt teacher-forced through the
caches, then greedy tokens).

    PYTHONPATH=src python -m repro_torch.serve_decode              # on the card
    PYTHONPATH=src python -m repro_torch.serve_decode --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.common.types import ModelConfig, resolve_device
from repro_torch.models import model as model_lib
from repro_torch.serve.steps import greedy_generate

CONFIGS = [
    ModelConfig(name="tiny-swa", family="dense", n_layers=4, d_model=128,
                n_heads=4, n_kv_heads=1, d_ff=512, vocab_size=512,
                attention_kind="sliding", window_size=32, dtype="float32"),
    ModelConfig(name="tiny-hybrid", family="hybrid", n_layers=4, d_model=128,
                n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512,
                layer_pattern=("mamba", "attention"), dtype="float32"),
    ModelConfig(name="tiny-rwkv", family="ssm", n_layers=2, d_model=128,
                n_heads=0, n_kv_heads=0, d_ff=512, vocab_size=512,
                layer_pattern=("rwkv6",), rwkv_head_dim=32, dtype="float32"),
]
B, PROMPT_LEN, MAX_NEW = 4, 16, 32


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, params=None, prompts=None) -> dict:
    """Greedy-decode every config of ``CONFIGS``; prints a line each and
    returns {name: {"tokens": (B, PROMPT_LEN + MAX_NEW), "seconds": host
    seconds ending in a device synchronize}}.  ``params`` / ``prompts``
    ({name: ...}) default to a seeded init and seeded prompts on the
    device."""
    dev = resolve_device(args.device)
    out = {}
    for i, cfg in enumerate(CONFIGS):
        p = params[cfg.name] if params else model_lib.init(cfg, seed=0, device=dev)
        if prompts:
            prompt = torch.as_tensor(prompts[cfg.name], device=dev)
        else:
            gen = torch.Generator(device=dev).manual_seed(1 + i)
            prompt = torch.randint(2, cfg.vocab_size, (B, PROMPT_LEN), generator=gen,
                                   device=dev)
        t0 = time.perf_counter()
        toks = greedy_generate(cfg, p, prompt, max_new=MAX_NEW,
                               max_len=PROMPT_LEN + MAX_NEW)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        if toks.shape != (B, PROMPT_LEN + MAX_NEW) or bool((toks < 0).any()):
            raise RuntimeError(f"{cfg.name}: generated {tuple(toks.shape)} tokens")
        print(f"{cfg.name:12s} generated {B}x{MAX_NEW} tokens in {dt:.2f}s "
              f"({B * MAX_NEW / dt:.0f} tok/s, eager on {dev}) "
              f"sample: {toks[0, PROMPT_LEN:PROMPT_LEN + 8].tolist()}")
        out[cfg.name] = {"tokens": toks, "seconds": dt}
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
