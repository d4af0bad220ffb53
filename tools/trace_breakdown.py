"""Where a traced step's device time and idle time go, by the program's own
spans (``repro_torch.common.trace``): one cell of the port's benchmark, on
the card.

    python3 tools/trace_breakdown.py --workload internlm2-1.8b.single_image \
        --seed 11 [--steps 10] [--out build/trace_breakdown]

Runs the benchmark's program (``portbench/drivers/dflop_train.py``'s
``Program``: the same loader, scheduler and train step, weights from the
seed) twice from one seed: its three set-up steps, then ``--steps`` steps
with the process's recorder off, and the same again with it on
(``trace.recording``), so that the cost of the recorder alone is read step
by step on the same batches; then, in the second program, the steps of
``dflop_train.traced`` under ``torch.profiler``, which switches the recorder on
as in the benchmark's ``--trace 1`` runs.  Of those it reports the six
readers of ``portbench/metrics/`` that read the program's spans, the phases'
device time against the device's busy time, each idle gap between device
operations named by the innermost span of the step's thread running at its
middle and by its overlap with the scheduler's search on the worker thread,
and how closely each mirrored span maps onto its copy in the profile.
Prints one JSON line and writes it, with the recorder's Chrome trace, under
``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from portbench import core, formulas  # noqa: E402
from portbench.metrics import fwd_ms, idle_in_search_ms  # noqa: E402
from repro_torch.common import trace  # noqa: E402

TRACED = 2                 # steps under the profiler, as the benchmark's
READERS = ("fwd_ms", "bwd_ms", "optim_ms", "pack_ms", "sched_search_ms", "idle_in_search_ms")


def steps(prog, n: int) -> list[float]:
    """Seconds of ``n`` steps, each from its batch's request to its
    synchronize."""
    out = []
    for _ in range(n):
        rec = prog.step()
        out.append(rec["wait_s"] + rec["seconds"])
    return out


def mapping(spans, host_ops, offset) -> dict:
    """Each mirrored span's largest gap from its profile copy after the one
    offset (profile minus recorder, µs)."""
    gaps = idle_in_search_ms.mirror_gaps(spans, host_ops)
    devs = sorted(((max(abs(a - offset), abs(b - offset)), n) for n, a, b in gaps),
                  reverse=True)
    return {"offset_us": offset, "n": len(gaps),
            "mirrored": sum(1 for s in spans if s["mirrored"]), "max_dev_us": devs[0][0],
            "worst": [[round(d, 1), n] for d, n in devs[:5]],
            "within_200us": sum(d <= 200.0 for d, _ in devs)}


def attribute(spans, tr, offset) -> dict:
    """Each idle gap of the traced span: its ms, the innermost span of the
    step's thread at its middle, and its overlap with the worker's search."""
    def placed(s):
        return (s["ts_us"] + offset) / 1e6, (s["ts_us"] + s["dur_us"] + offset) / 1e6

    t0, t1 = tr["span"]
    caller = [(placed(s), s["name"]) for s in spans if s["mirrored"]]
    search = [placed(s) for s in spans if s["name"] == "sched.schedule"]
    gaps = []
    for a, b in formulas.idle_gaps([(x, y) for _, x, y in tr["device_ops"]], t0, t1):
        mid = (a + b) / 2
        inner = [(s, n) for (s, e), n in caller if s <= mid <= e]
        over = sum(max(0.0, min(b, d) - max(a, c)) for c, d in search)
        gaps.append((b - a, max(inner)[1] if inner else "none", over))
    n = len(tr["steps"])
    by_span = {}
    for ms, name, _ in gaps:
        by_span[name] = by_span.get(name, 0.0) + 1e3 * ms / n
    return {"idle_ms": 1e3 * sum(g[0] for g in gaps) / n,
            "idle_by_span_ms": {k: round(v, 3) for k, v in sorted(by_span.items(),
                                                                 key=lambda x: -x[1])},
            "top_gaps": [[round(1e3 * ms, 3), name, round(1e3 * o, 3)]
                         for ms, name, o in sorted(gaps, reverse=True)[:10]]}


def breakdown(cell: dict, seed: int, n_steps: int, device="cuda") -> dict:
    drv = core.load_module("drivers", cell["traffic"]["driver"])
    out = {"workload": cell["name"], "seed": seed,
           "device": torch.cuda.get_device_name(0) if device == "cuda" else device}
    for on in (False, True):
        prog = drv.Program(cell, seed, device)
        with trace.recording(on):
            steps(prog, drv.SETUP_STEPS)
            t = time.perf_counter()
            out["on" if on else "off"] = steps(prog, n_steps)
            out[("on" if on else "off") + "_window_s"] = time.perf_counter() - t
        if on:
            trace.recorder().clear()
            tr = drv.traced(prog, TRACED)
        prog.close()
    out["on_minus_off_ms"] = [1e3 * (a - b) for a, b in zip(out["on"], out["off"])]
    rec = {"trace": tr}
    spans = fwd_ms.program_spans(rec)
    offset = idle_in_search_ms.offset_us(spans, tr["host_ops"])
    out["mapping"] = mapping(spans, tr["host_ops"], offset)
    out["metrics"] = {n: core.load_module("metrics", n).read(rec) for n in READERS}
    t0, t1 = tr["span"]
    busy_ms = 1e3 * formulas.busy_union([(a, b) for _, a, b in tr["device_ops"]], t0, t1) / TRACED
    phases = sum(out["metrics"][n] or 0.0 for n in ("fwd_ms", "bwd_ms", "optim_ms"))
    out["traced"] = {"span_ms": 1e3 * (t1 - t0) / TRACED, "busy_ms": busy_ms,
                     "phases_over_busy": phases / max(busy_ms, 1e-9),
                     "phases_over_span": phases / (1e3 * (t1 - t0) / TRACED),
                     **attribute(spans, tr, offset)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default="build/trace_breakdown")
    args = ap.parse_args(argv)
    out = breakdown(core.cell(core.benchmark(), args.workload), args.seed, args.steps)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    stem = f"{args.workload}.{args.seed}"
    trace.recorder().export(str(path / f"{stem}.chrome.json"))
    (path / f"{stem}.json").write_text(json.dumps(out))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
