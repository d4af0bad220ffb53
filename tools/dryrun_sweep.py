"""Run the dry run over every (architecture x input shape x mesh) of the
reference's ``--all`` sweep, several combinations side by side, and print
one table row a combination.

Each combination is its own ``python -m repro_torch.launch.dryrun``
process (fake tensors on the host's cores; ``--device cuda`` by default
asks the card's driver for the mesh, as the entry point does), writing its
record under ``--out``; a combination still running at ``--timeout``
seconds is killed and reported as such.  The table columns: ok / skip /
fail / timeout, peak GB a rank, fits_80gb, FLOPs a rank, the useful ratio
model_flops / n_chips / FLOPs, and collective bytes a rank by kind.  The
numbers are the dry run's predictions, not measurements.

    python3 tools/dryrun_sweep.py [--jobs 8] [--timeout 900] [--out build/dryrun]
        [--archs a,b] [--shapes train_4k,...] [--meshes 16x16,2x16x16]
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))

from repro_torch.common.types import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.launch.hlo_stats import COLLECTIVES  # noqa: E402

MESHES = {"16x16": False, "2x16x16": True}


def row(arch, shape, mesh, status, rec, wall):
    if status != "ok" or rec.get("skipped"):
        note = rec.get("reason") or rec.get("error") or status
        return (f"| {arch} | {shape} | {mesh} | {'skip' if rec.get('skipped') else status} "
                f"| — | — | — | — | — | {note[:90]} |")
    hlo, mem = rec["hlo"], rec["memory"]
    coll = ", ".join(f"{k} {hlo['collective_bytes'][k]:.3g}" for k in COLLECTIVES
                     if hlo["collective_bytes"].get(k))
    useful = rec["model_flops"] / rec["n_chips"] / hlo["flops"]
    return (f"| {arch} | {shape} | {mesh} | ok ({wall:.0f} s) | "
            f"{mem['peak_per_chip'] / 1e9:.2f} | {rec['fits_80gb']} | {hlo['flops']:.3e} | "
            f"{useful:.3f} | {hlo['total_collective_bytes']:.3e} | {coll} |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--out", default=os.path.join(HERE, "build", "dryrun"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--archs", default=",".join(ASSIGNED))
    ap.add_argument("--shapes", default=",".join(INPUT_SHAPES))
    ap.add_argument("--meshes", default=",".join(MESHES))
    args = ap.parse_args()
    combos = [(a, s, m) for a in args.archs.split(",") for s in args.shapes.split(",")
              for m in args.meshes.split(",")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")])))
    pending, running, rows = list(combos), [], {}
    t_all = time.monotonic()
    while pending or running:
        while pending and len(running) < args.jobs:
            a, s, m = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
                   "--shape", s, "--out", args.out, "--device", args.device]
            cmd += ["--multi-pod"] if MESHES[m] else []
            running.append(((a, s, m), time.monotonic(), subprocess.Popen(
                cmd, env=env, cwd=HERE, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)))
        time.sleep(1.0)
        for item in list(running):
            (a, s, m), t0, proc = item
            wall = time.monotonic() - t0
            if proc.poll() is None and wall < args.timeout:
                continue
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                status = "timeout"
            else:
                status = "ok" if proc.returncode == 0 else "fail"
            running.remove(item)
            path = os.path.join(args.out, f"{a}__{s}__{m}.json")
            rec = {}
            if status != "timeout" and os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
            rows[(a, s, m)] = row(a, s, m, status, rec, wall)
            print(f"[sweep] {rows[(a, s, m)]}", flush=True)
    print(f"[sweep] {len(combos)} combinations in {time.monotonic() - t_all:.0f} s")
    print("| arch | shape | mesh | status | peak GB a rank | fits_80gb | FLOPs a rank "
          "| useful ratio | collective B a rank | by kind |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for c in combos:
        print(rows[c])


if __name__ == "__main__":
    main()
