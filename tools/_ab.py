"""What the kernel A/B tools (``pfa_ab.py``, ``mamba_ab.py``,
``rwkv6_ab.py``) share: a second build of a library's source beside this
tree's, CUDA-event times of both in turns, and the card's name and power
limit.  Needs a CUDA card."""
from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.kernels import build  # noqa: E402

ITERS = 20          # launches a time averages


def libraries(name, baseline=None, flags=()):
    """{"new": this tree's library ``name``} and, given a ``baseline``
    source, {"baseline": its build}; with the ptxas lines of each build
    ({} for a library loaded from the build cache)."""
    libs = {"new": build.load(name)}
    lines = {"new": build.LOG.ptxas.get(name, [])}
    if baseline:
        libs["baseline"], lines["baseline"] = build.load_from(baseline, name, flags)
    return libs, lines


def cuda_ms(fn, iters=ITERS):
    """Mean ms of ``fn`` on the card over ``iters`` launches, after 3."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def in_turns(name, libs, measure):
    """``measure()`` with each build of ``name`` swapped in, in turns:
    baseline, new, new, baseline (new alone without a baseline); a list of
    (build, result).  Leaves this tree's build in place."""
    order = ("baseline", "new", "new", "baseline") if "baseline" in libs else ("new",)
    out = []
    for which in order:
        build.use(name, libs[which])
        out.append((which, measure()))
    build.use(name, libs["new"])
    return out


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip() or smi.stderr.strip()
