"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload internlm2-1.8b.mixed --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The cell's configuration, traffic mix,
limits and metric readers are found by the names in ``BENCHMARK.json``
(``portbench/core.py``).  With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and a
breakdown of the traced steps.  The last lines on standard error, and the
result's last key, give each number compared against its limit.  Without a
CUDA card (or with fewer than the cell asks for) it exits with 2 and prints
no result; so it does when a module of JAX, Flax or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from portbench import core  # noqa: E402

NAME_CHARS = 160        # a kernel name in the breakdown is cut to this


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def breakdown(tr: dict) -> dict:
    """The traced steps' ten device operations with the most time, and the
    ten longest idle gaps, each named by the innermost host operation
    running at its middle."""
    from portbench import formulas
    per_name: dict[str, float] = {}
    for name, a, b in tr["device_ops"]:
        per_name[name] = per_name.get(name, 0.0) + (b - a)
    top = sorted(per_name.items(), key=lambda x: -x[1])[:10]
    gaps = sorted(formulas.idle_gaps([(a, b) for _, a, b in tr["device_ops"]], *tr["span"]),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        inner = [(s, n) for n, s, e in tr["host_ops"] if s <= mid <= e
                 and n != "portbench.traced_steps"]
        named.append([("host: " + max(inner)[1]) if inner else "host: none traced", b - a])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top], "idle_gaps": named}


def device_info(torch, rec: dict, chips: int) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": rec["peak_bytes"], "power_limit": power_limit()}
    tr = rec["trace"]
    if tr is not None and tr["span"]:
        from portbench import formulas
        t0, t1 = tr["span"]
        info["busy_s"] = formulas.busy_union([(a, b) for _, a, b in tr["device_ops"]], t0, t1)
        info["window_s"] = t1 - t0
    return info


def main(argv=None) -> int:
    args = parse(argv)
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    driver = core.load_module("drivers", cell["traffic"]["driver"])
    rec = driver.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                     t_start=T_START)
    found = core.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    correct, checks = core.judge(rec["checks"], cell["limits"])
    correct = correct and rec["failed"] == 0 and rec["attempted"] > 0
    metrics = {}
    if args.trace:
        for m in bench["per_layer"]:
            value = core.load_module("metrics", m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if m["name"] in rec["end_to_end"]:
                metrics[m["name"]] = {"value": rec["end_to_end"][m["name"]], "unit": m["unit"]}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device_info(torch, rec, cell["chips"])}
    if args.trace and rec["trace"] and rec["trace"]["span"]:
        result["breakdown"] = breakdown(rec["trace"])
    result["checks"] = checks
    for note in rec["notes"]:
        print(f"portbench: {note}", file=sys.stderr)
    print(f"portbench: {args.workload} seed {args.seed}: {len(rec['window']['steps'])} steps "
          f"in {rec['window']['seconds']:.3f} s, set-up {rec['setup_parts']}, check "
          f"{rec['check_s']:.1f} s, plan {rec['plan']}, "
          f"{result['device']['power_limit']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
