"""Planner inspection: the Profiling Engine and the Data-aware Optimizer for a
paper-scale MLLM on a cluster of H100s, printing the chosen plan against
tuned uniform baselines (the paper's Fig. 3 offline phase, end to end); the
port's counterpart of the reference's ``examples/plan_inspector.py``.

    PYTHONPATH=src python -m repro_torch.plan_inspector [--arch llava-ov-qwen7b]
        [--chips 256] [--gbs 256] [--objective mean] [--device cpu]

The planner is numpy on the host: plans are priced by the analytic H100
spec (``analytic.H100``) on nodes of 8 cards of 80 GB, ``quickstart.CLUSTER``'s
form at ``--chips``.  ``--device`` (default ``cuda``) names the device the
plan is for; without a card ``cuda`` raises, as every entry point does.
"""
from __future__ import annotations

import argparse

from repro_torch.common.types import resolve_device
from repro_torch.configs import get_config, list_archs
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.objective import MeanObjective
from repro_torch.core.optimizer.space import ClusterSpec
from repro_torch.core.profiling.analytic import H100, AnalyticBackend, HardwareSpec
from repro_torch.data.synthetic import MixedDataset

BASELINE_TP, BASELINE_PP = (1, 2, 4, 8, 16), (1, 2, 4)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llava-ov-qwen7b", choices=list_archs())
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--gbs", type=int, default=256)
    ap.add_argument("--objective", default="mean",
                    choices=["mean", "expected-random", "balanced-quantile"],
                    help="search objective (balanced-quantile is "
                         "heterogeneity-aware: try it at small --gbs)")
    ap.add_argument("--seed", type=int, default=0,
                    help="Monte-Carlo seed for the sampling objectives")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, *, hardware: HardwareSpec = H100, chips_per_node: int = 8) -> dict:
    """Profile, plan and price the baselines for ``args``; prints the
    reference's lines and returns what they hold: the data summary
    (``mean_batch``, ``mean_seq``, ``cv``), the ``result`` (θ*, makespan,
    configs searched), the chosen plan's mean-shape makespan ``ref`` and the
    feasible ``baselines`` {(tp, pp): makespan}, plus the ``engine``."""
    dev = resolve_device(args.device)
    spec = get_config(args.arch)
    tpm = spec.tokens_per_media_item or 196
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=tpm)
    cluster = ClusterSpec(n_chips=args.chips, chips_per_node=chips_per_node,
                          mem_bytes=hardware.mem_bytes, name=hardware.name)
    eng = DFLOPEngine(
        llm_cfg=spec.llm_cfg,
        enc_cfg=spec.desc.encoder if spec.is_mllm else None,
        e_seq_len=spec.desc.stub.n_tokens if spec.is_mllm else 0,
        cluster=cluster, tokens_per_media_item=tpm,
        backend=AnalyticBackend(hardware))
    eng.profile(ds)
    mb, ms = eng.dist.mean()
    cv = eng.dist.heterogeneity()
    print(f"[plan] {args.arch} on {args.chips} x {hardware.name} "
          f"({chips_per_node} a node), planned for device {dev}")
    print(f"[data]  mean enc batch {mb:.1f} items, mean LLM seq {ms:.0f} "
          f"tokens, heterogeneity CV={cv:.2f}")

    eng.objective = args.objective
    res = eng.plan(args.gbs, seed=args.seed)
    # as_tuple also carries the pipeline schedule (the reference's example
    # unpacks seven values and raises on the eighth)
    e_tp, e_pp, e_dp, l_tp, l_pp, l_dp, n_mb, sched = res.plan.as_tuple()
    print(f"[theta*] encoder (tp={e_tp}, pp={e_pp}, dp={e_dp})  "
          f"llm (tp={l_tp}, pp={l_pp}, dp={l_dp})  N_mb={n_mb}  schedule={sched}")
    print(f"[theta*] expected makespan {res.makespan:.4f}s  "
          f"searched {res.n_configs} configs / {res.n_feasible} feasible "
          f"in {res.elapsed_s * 1e3:.0f} ms")

    # baselines are scored by the mean-shape estimate; compare them against
    # the chosen plan under the same estimator so the ratios are
    # like-for-like even when a sampling objective picked the plan
    ref = MeanObjective().evaluate(eng.perf, res.plan, eng.dist, args.gbs)
    print("[baselines] uniform (tp, pp) grid, memory-feasible only:")
    baselines = {}
    for tp in BASELINE_TP:
        for pp in BASELINE_PP:
            b = eng.baseline_plan(args.gbs, tp=tp, pp=pp)
            if b.found and b.makespan != float("inf"):
                baselines[(tp, pp)] = b.makespan
                print(f"    tp={tp:2d} pp={pp}: makespan {b.makespan:.4f}s "
                      f"({b.makespan / ref:.2f}x DFLOP)")
    return {"mean_batch": mb, "mean_seq": ms, "cv": cv, "result": res, "ref": ref,
            "baselines": baselines, "engine": eng}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
