"""Quickstart: DFLOP end to end on one card, the port's counterpart of the
reference's ``examples/quickstart.py``.

Profiles the synthetic mixed multimodal data, plans the parallelism with the
Data-aware Optimizer, then trains a decoder on one device with the Online
Microbatch Scheduler feeding balanced, sequence-packed microbatches:
``DFLOPEngine.profile`` → ``plan`` → ``scheduler`` → ``ScheduledLoader`` →
``make_train_step``.

    PYTHONPATH=src python -m repro_torch.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --tiny --device cpu

By default the decoder is InternVL2-2B's LLM, InternLM2-1.8B, at full width
and depth in bf16 (fp32 parameters, gradients and AdamW moments, ≈30 GB),
priced by the H100 spec on eight 80 GB cards: 8 items a step, scheduled into
4 microbatches of one 8192-token row (the mix averages ≈2.8k LLM tokens an
item at 256 tokens an image).  ``--tiny`` takes the reference quickstart's
tiny fp32 decoder and sizes: 16 items into 4 rows of 512 tokens.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.common.types import ModelConfig, resolve_device
from repro_torch.configs import internvl2_2b
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.search import SearchResult
from repro_torch.core.optimizer.space import ClusterSpec, ModuleParallelism, ParallelismPlan
from repro_torch.core.profiling.analytic import H100
from repro_torch.data.loader import ScheduledLoader
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import model as model_lib
from repro_torch.models.model import FwdCtx
from repro_torch.train import optim, step

# the cluster the plan is priced for: one node of eight H100s
CLUSTER = ClusterSpec(n_chips=8, chips_per_node=8, mem_bytes=H100.mem_bytes,
                      name="h100-sxm")
# the single-host plan the loop runs: dp 1, N_mb microbatches of one row
LOCAL_PLAN = ParallelismPlan(llm=ModuleParallelism(1, 1, 1), n_mb=4)
PLAN_GBS = 64


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What the loop trains and how the loader fills it."""

    cfg: ModelConfig
    tokens_per_media_item: int
    gbs: int                     # items a step
    token_budget: int            # tokens a row
    ilp_time_limit_s: float
    lr: float


CARD = Sizes(cfg=internvl2_2b.LLM,
             tokens_per_media_item=internvl2_2b.LLM_TOKENS_PER_IMAGE,
             gbs=8, token_budget=8192, ilp_time_limit_s=0.25, lr=3e-4)
TINY = Sizes(cfg=ModelConfig(name="tiny", family="dense", n_layers=4, d_model=128,
                             n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512,
                             dtype="float32"),
             tokens_per_media_item=8, gbs=16, token_budget=512,
             ilp_time_limit_s=0.05, lr=3e-3)


def plan(sizes: Sizes, dataset: MixedDataset) -> tuple[DFLOPEngine, SearchResult, float, float]:
    """Profile the mix and plan the decoder on ``CLUSTER`` at ``PLAN_GBS``:
    (engine, result, profile seconds, plan seconds) on the host clock."""
    eng = DFLOPEngine(llm_cfg=sizes.cfg, cluster=CLUSTER,
                      tokens_per_media_item=sizes.tokens_per_media_item)
    t0 = time.perf_counter()
    eng.profile(dataset)
    t1 = time.perf_counter()
    res = eng.plan(gbs=PLAN_GBS)
    return eng, res, t1 - t0, time.perf_counter() - t1


def make_loader(sizes: Sizes, eng: DFLOPEngine, dataset: MixedDataset) -> ScheduledLoader:
    """The scheduler on ``LOCAL_PLAN`` feeding packed (N_mb, 1, budget) rows."""
    sched = eng.scheduler(plan=LOCAL_PLAN, adaptive=True,
                          ilp_time_limit_s=sizes.ilp_time_limit_s)
    return ScheduledLoader(dataset, sched, gbs=sizes.gbs,
                           token_budget=sizes.token_budget,
                           vocab_size=sizes.cfg.vocab_size, seed=0)


def train(sizes: Sizes, loader: ScheduledLoader, *, steps: int, device, lr: float,
          params=None):
    """``steps`` AdamW steps on the loader's batches; ``params`` default to
    a seeded init on ``device``.  Yields (params, record) after each step;
    the record holds the loss, the step's host seconds (ending in a device
    synchronize), the loader's seconds for the batch, the batch's
    ``ScheduleOutput`` (groups, solver, imbalance, the predicted step), the
    tokens in segments of each row, the tokens the packing truncated and
    the peak device GiB (None on the CPU)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if params is None:
        params = model_lib.init(sizes.cfg, seed=0, device=dev)
    opt = optim.adamw_init(params)
    train_step = step.make_train_step(sizes.cfg, optim.AdamWConfig(lr=lr), ctx=FwdCtx())
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    it = iter(loader)
    for k in range(steps):
        t0 = time.perf_counter()
        batch = next(it)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, step.as_tensors(batch, device=dev), lr)
        loss = m["loss"].item()
        if cuda:
            torch.cuda.synchronize(dev)
        yield params, {
            "step": k, "loss": loss, "seconds": time.perf_counter() - t0,
            "load_seconds": load_s, "schedule": loader.last_schedule,
            "row_tokens": (batch["segment_ids"] > 0).sum(-1).ravel().tolist(),
            "truncated": loader.last_truncated,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the reference quickstart's tiny fp32 decoder and sizes")
    ap.add_argument("--steps", type=int, default=3)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    sizes = TINY if args.tiny else CARD
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=sizes.tokens_per_media_item)

    # 1) Profiling Engine + Data-aware Optimizer (the analytic H100 backend)
    eng, res, profile_s, plan_s = plan(sizes, ds)
    print(f"[plan] {sizes.cfg.name} on {CLUSTER.n_chips} x {CLUSTER.name}: theta*="
          f"{res.plan.as_tuple()}  expected makespan={res.makespan:.4f}s  "
          f"({res.n_configs} configs; profile {profile_s:.3f} s, plan {plan_s:.3f} s)",
          flush=True)

    # 2) Online Microbatch Scheduler feeding the training loop on one device
    #    (the single-host plan: dp 1, N_mb microbatches)
    loader = make_loader(sizes, eng, ds)
    for _, r in train(sizes, loader, steps=args.steps, device=dev, lr=sizes.lr):
        sc = r["schedule"]
        peak = "" if r["peak_gib"] is None else f"  peak {r['peak_gib']:.2f} GiB"
        print(f"step {r['step']:3d}  loss={r['loss']:.4f}  {r['seconds']:.3f} s  schedule: "
              f"solver={sc.solver} imbalance={sc.imbalance:.4f} "
              f"predicted step={sc.step_makespan:.4f}s rows={r['row_tokens']} "
              f"truncated={r['truncated']}{peak}", flush=True)
        if not math.isfinite(r["loss"]):
            raise SystemExit("non-finite loss")
    print(f"[done] {args.steps} steps on {dev}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
