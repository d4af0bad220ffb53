"""End to end: train a ~100M-param MLLM with DFLOP on synthetic mixed
multimodal data, comparing the Online Microbatch Scheduler against random
(data-agnostic) assignment; the port's counterpart of the reference's
``examples/train_mllm.py``.

Scheduling runs through the ``repro_torch.runtime`` control loop: every
step's wall time (host clock, ending in a device synchronize) feeds back into
calibration + drift detection, and ``--trace`` exports a Chrome trace (load
in https://ui.perfetto.dev) of the run.  ``--replan`` additionally lets the
controller re-plan in the background and hot-swap θ* when the data
distribution drifts.  On one card the swap is logical (the scheduler takes
the new plan; no parameter is re-laid-out).  ``--shift-at K`` switches the
data mixture single-image → video at step K to force a mid-run drift.

    PYTHONPATH=src python -m repro_torch.train_mllm [--steps 200] [--random]
        [--trace build/runtime_trace.json] [--replan] [--shift-at 8]
        [--compose-window 2] [--ckpt build/runtime_ckpt]
    PYTHONPATH=src python -m repro_torch.train_mllm --tiny --device cpu --steps 8

The model is fp32 throughout, so its attention takes the kernels' fp32
route; the plan is priced by the analytic H100 spec on 16 cards of 80 GB.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.common.types import MLLMConfig, ModalityStub, ModelConfig, resolve_device
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.space import ClusterSpec, ModuleParallelism, ParallelismPlan
from repro_torch.core.profiling.analytic import H100
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import mllm as mllm_lib
from repro_torch.models.model import FwdCtx
from repro_torch.runtime import DriftDetector
from repro_torch.train import checkpoint
from repro_torch.train.optim import AdamWConfig, adamw_init, cosine_lr
from repro_torch.train.step import as_tensors, make_train_step

ENC = ModelConfig(name="enc-100m", family="vlm-enc", n_layers=6, d_model=384,
                  n_heads=6, n_kv_heads=6, d_ff=1536, vocab_size=0,
                  causal=False, use_rope=False, input_embed_dim=64,
                  has_lm_head=False, dtype="float32")
LLM = ModelConfig(name="llm-100m", family="dense", n_layers=8, d_model=512,
                  n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=8192,
                  dtype="float32")
MCFG = MLLMConfig(name="mllm-100m", encoder=ENC, llm=LLM,
                  stub=ModalityStub("vision", 16, 64), connector_hidden=512,
                  tokens_per_item_out=4)

TPM = 4          # connector tokens per media item
GBS = 16
MAX_MEDIA = 8 * 16       # encoder tokens cap
MAX_TEXT = 384
# the cluster the plan is priced for: 16 H100s of 80 GB in one node
CLUSTER = ClusterSpec(n_chips=16, chips_per_node=16, mem_bytes=H100.mem_bytes)
# the plan the loop starts from: dp 1, N_mb 4 microbatches
LOCAL_PLAN = ParallelismPlan(llm=ModuleParallelism(1, 1, 1),
                             encoder=ModuleParallelism(1, 1, 1), n_mb=4)


def build_batches(ds, plan, items, groups, n_mb, vocab_size=LLM.vocab_size):
    """Tensorize scheduler groups -> (n_mb, rows, ...) MLLM batch (numpy)."""
    dp = plan.llm.dp
    rows = []
    for i in range(n_mb):
        row_items = []
        for r in range(dp):
            row_items += [items[j] for j in groups[i * dp + r]]
        rows.append(row_items or [items[0]])
    # pad rows to a power of two so batch shapes stay stable across steps
    # (the reference's jit cache keys on them; the port keeps its batches)
    per_row = max(len(r) for r in rows)
    per_row = 1 << (per_row - 1).bit_length()
    batches = []
    for row_items in rows:
        row_items = (row_items * per_row)[:per_row]
        batches.append(ds.materialize(row_items, embed_dim=64,
                                      vocab_size=vocab_size,
                                      max_media=MAX_MEDIA, max_text=MAX_TEXT))
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def tiny_configs():
    """Sub-1M-param variant for smoke tests: seconds on a CPU while
    exercising the identical control-loop code paths."""
    enc = ModelConfig(name="enc-tiny", family="vlm-enc", n_layers=2,
                      d_model=96, n_heads=4, n_kv_heads=4, d_ff=384,
                      vocab_size=0, causal=False, use_rope=False,
                      input_embed_dim=64, has_lm_head=False, dtype="float32")
    llm = ModelConfig(name="llm-tiny", family="dense", n_layers=2,
                      d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                      vocab_size=1024, dtype="float32")
    mcfg = MLLMConfig(name="mllm-tiny", encoder=enc, llm=llm,
                      stub=ModalityStub("vision", 16, 64),
                      connector_hidden=128, tokens_per_item_out=4)
    return enc, llm, mcfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--random", action="store_true",
                    help="random (data-agnostic) microbatch assignment")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--trace", default="",
                    help="export a Chrome trace of the run to this path")
    ap.add_argument("--replan", action="store_true",
                    help="enable background re-planning on drift, with a "
                         "logical plan hot-swap")
    ap.add_argument("--shift-at", type=int, default=0,
                    help="switch the data mixture single-image -> video at "
                         "this step (0 = keep the mixed stream)")
    ap.add_argument("--objective", default="mean",
                    choices=["mean", "expected-random", "balanced-quantile"],
                    help="search objective used by background re-planning")
    ap.add_argument("--compose-window", type=int, default=0,
                    help="lookahead batch composition over a window of "
                         "this many global batches (0 = FIFO draws)")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="max batches an item may wait in the compose "
                         "window (0 = default, 2x the window)")
    ap.add_argument("--tiny", action="store_true",
                    help="sub-1M-param model (smoke: seconds on a CPU, same "
                         "control-loop code paths)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.random and args.replan:
        ap.error("--random bypasses the control loop (schedule_random "
                 "never reaches the controller), so --replan would only "
                 "adopt plans at exit; drop one of the two flags")
    return args


def run(args, params=None) -> dict:
    """The training loop of ``args`` (``parse_args``); ``params`` default to
    a seeded init on the device.  Returns the run: ``steps`` (per step the
    loss, the step's host seconds, the ``ScheduleOutput``, the items and
    whether a re-plan search was in flight while the step ran), the
    controller ``ctl`` (closed), the final ``params`` and ``opt``, the
    ``train_step``, the last step's tensor ``batch`` and ``lr``, the peak
    device GiB (None on the CPU) and the loop's wall seconds."""
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    enc_cfg, llm_cfg, mcfg = tiny_configs() if args.tiny else (ENC, LLM, MCFG)
    if args.shift_at:
        ds = MixedDataset("single_image", seed=0, tokens_per_media_item=TPM)
        post_ds = MixedDataset("video", seed=1, tokens_per_media_item=TPM)
    else:
        ds = MixedDataset("mixed", seed=0, tokens_per_media_item=TPM)
        post_ds = None
    eng = DFLOPEngine(llm_cfg=llm_cfg, enc_cfg=enc_cfg, e_seq_len=16,
                      cluster=CLUSTER, tokens_per_media_item=TPM,
                      objective=args.objective)
    eng.profile(ds)

    if params is None:
        params = mllm_lib.init(mcfg, seed=0, device=dev)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[model] {n_params/1e6:.1f}M params  device={dev}", flush=True)

    # tighter drift window than the default so a --shift-at demo fires
    # within a few global batches at GBS 16
    drift = DriftDetector(window=128, check_every=32, cooldown=64)
    ctl = eng.runtime(GBS, plan=LOCAL_PLAN, adaptive=True, ilp_time_limit_s=0.05,
                      auto_replan=args.replan, drift=drift,
                      compose_window=args.compose_window,
                      max_staleness=args.max_staleness or None)
    sched = ctl.scheduler
    composer = ctl.composer

    lr_fn = cosine_lr(1e-3, warmup=20, total=args.steps)
    step = make_train_step(mcfg, AdamWConfig(lr=1e-3),
                           ctx=FwdCtx(mode="train", attn_impl="kernel"))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    losses, pred_cmax, steps = [], [], []
    batch = None
    t0 = time.time()
    for k in range(args.steps):
        active_ds = post_ds if (post_ds and k >= args.shift_at) else ds
        if composer is not None:
            # refills the window to capacity (first call warms the full
            # W-batch lookahead), then emits one composed batch
            items = ctl.compose(draw=lambda: active_ds.sample(GBS))
        else:
            items = active_ds.sample(GBS)
        out = (sched.schedule_random(items, seed=k) if args.random
               else ctl.schedule(items))
        pred_cmax.append(out.cmax)
        batch = as_tensors(build_batches(active_ds, out.plan, items, out.groups,
                                         out.plan.n_mb, vocab_size=llm_cfg.vocab_size),
                           device=dev)
        in_flight = ctl.replan_in_flight
        ts = time.perf_counter()
        params, opt, m = step(params, opt, batch, lr_fn(k))
        loss = m["loss"].item()
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - ts
        ctl.observe_step(out, seconds)
        # NaN (no MoE layers) is skipped, not recorded
        ctl.metrics.record_moe(float(m["moe_drop_rate"]),
                               float(m["moe_imbalance"]))
        losses.append(loss)
        steps.append({"step": k, "loss": loss, "seconds": seconds,
                      "schedule": out, "items": items, "in_flight": in_flight})
        if k % 25 == 0:
            print(f"step {k:4d}  loss={losses[-1]:.3f}  {seconds:.3f}s  "
                  f"pred C_max={out.cmax:.4f}s  solver={out.solver}", flush=True)
    dt = time.time() - t0
    mode = "random" if args.random else "dflop"
    snap = ctl.metrics.snapshot()

    def fmt(key, scale=1.0, spec=".4f"):
        # snapshot stats are None when their window is empty ("no data")
        v = snap[key]
        return "n/a" if v is None else f"{v * scale:{spec}}"

    print(f"[{mode}] {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}; "
          f"mean predicted C_max {np.mean(pred_cmax):.4f}s; "
          f"mean step {np.mean([s['seconds'] for s in steps]):.4f}s")
    print(f"[runtime] imbalance={fmt('imbalance_mean')}  "
          f"sched_overhead={fmt('sched_elapsed_mean_s', 1e3, '.2f')}ms  "
          f"drift_events={snap['n_drift_events']}  "
          f"replans={snap['n_replans']}  "
          f"physical_swaps={snap['n_physical_swaps']}  "
          f"reshard_mean_s={fmt('reshard_mean_s')}  "
          f"moe_drop={fmt('moe_drop_rate_mean')}  "
          f"moe_imbalance={fmt('moe_imbalance_max')}")
    if composer is not None:
        print(f"[compose] batches={snap['n_composed']}  "
              f"pred_gain_mean={fmt('compose_pred_gain_mean', 1.0, '.3f')}  "
              f"forced_items={snap['n_forced_items']}  "
              f"overhead={fmt('compose_elapsed_mean_s', 1e3, '.2f')}ms")
    ctl.close()
    if args.trace:
        print(f"chrome trace written to {ctl.export_trace(args.trace)}")
    if args.ckpt:
        checkpoint.save(args.ckpt, params, {"steps": args.steps,
                                            "loss": losses[-1]})
        print(f"checkpoint written to {args.ckpt}")
    return {"steps": steps, "ctl": ctl, "params": params, "opt": opt,
            "train_step": step, "batch": batch, "lr": lr_fn(args.steps - 1),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "wall_s": dt, "cfg": mcfg}


def main(argv=None) -> int:
    r = run(parse_args(argv))
    if not all(math.isfinite(s["loss"]) for s in r["steps"]):
        raise SystemExit("non-finite loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
