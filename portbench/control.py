"""Readings that set a training cell's limits: the program's sound runs, the
control and the planted faults, at the cell's own size, without a window.

    python3 portbench/control.py --workload internlm2-1.8b.mixed \
        --seeds 11 12 13 ... --control-seeds 11 12 13 \
        --faults half_batch no_decay ascent --fault-seeds 11 12 13

For every seed of ``--seeds``: the program's check steps (set-up as a run
makes them) against the plain reference, the compared numbers.  For each
seed of ``--control-seeds`` (a subset of ``--seeds``): the control, the
reference computed with bf16 activations and bf16 parameters, gradients
and AdamW moments in the program's place, against the same reference.
For each of ``--fault-seeds`` and each fault of ``--faults``: the program
with that fault planted (``drivers/dflop_train.py``): ``half_batch`` (half
of each step's microbatches left out), ``no_decay`` (AdamW without weight
decay), ``ascent`` (the step up the gradient), ``unchanged`` (the state
returned unchanged: it reads 1 on ``update``, ``decay`` and ``descent`` by
construction; its other numbers are read).  One JSON line a reading on
standard output; ``--out`` also writes them all to a file.
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

from portbench import core  # noqa: E402

CONTROL = {"compute": torch.bfloat16, "state": torch.bfloat16}


def program_readings(drv, cell: dict, seed: int, device, fault=None):
    """(readings, reference batches of the check steps, data mismatches)."""
    prog = drv.Program(cell, seed, device, fault)
    readings = prog.check_steps()
    draws, loaded = prog.stream.drawn, prog.loaded
    prog.close()
    bad, batches, first = drv.data_check(cell, seed, draws, loaded)
    return readings, batches[:drv.CHECK_STEPS], bad, first


def readings_for(cell: dict, seed: int, device, *, control=False, fault=None) -> dict:
    """The compared numbers of one seed: the program's (with ``fault``
    planted) or, with ``control``, the control's, against the reference."""
    drv = core.load_module("drivers", cell["traffic"]["driver"])
    t0 = time.perf_counter()
    prog, batches, bad, first = program_readings(drv, cell, seed, device, fault)
    ref = drv.reference_readings(cell, seed, batches, device)
    out = {"seed": seed, "who": "program" if fault is None else fault,
           "numbers": {"data": float(bad), **drv.compare(prog, ref)}, "note": first}
    rows = [out]
    if control:
        ctl = drv.reference_readings(cell, seed, batches, device, **CONTROL)
        rows.append({"seed": seed, "who": "control",
                     "numbers": {"data": 0.0, **drv.compare(ctl, ref)}, "note": ""})
    for r in rows:
        r["seconds"] = time.perf_counter() - t0
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=["half_batch"])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = core.cell(core.benchmark(), args.workload)
    rows = []
    for seed in args.seeds:
        for r in readings_for(cell, seed, "cuda", control=seed in args.control_seeds):
            print(json.dumps(r), flush=True)
            rows.append(r)
    for fault in args.faults:
        for seed in args.fault_seeds:
            for r in readings_for(cell, seed, "cuda", fault=fault):
                print(json.dumps(r), flush=True)
                rows.append(r)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
