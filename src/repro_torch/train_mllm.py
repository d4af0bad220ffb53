"""End to end: train a ~100M-param MLLM with DFLOP on synthetic mixed
multimodal data, comparing the Online Microbatch Scheduler against random
(data-agnostic) assignment; the port's counterpart of the reference's
``examples/train_mllm.py``.

Scheduling runs through the ``repro_torch.runtime`` control loop: every
step's wall time (host clock, ending in a device synchronize) feeds back into
calibration + drift detection, and ``--trace`` exports a Chrome trace (load
in https://ui.perfetto.dev) of the run: the controller's spans and counters
and the program's own (``common.trace``: the scheduler's search, the step's
upload, forward, backward and optimizer, with their device times on a lane
of their own), in the process's recorder.  With it, each step's idle device
time (its wall time less its device spans) feeds the bubble fraction.
``--replan`` additionally lets the controller re-plan in the background and
hot-swap θ* when the data distribution drifts — and the swap is *physical*:
the live (params, opt) state goes through a
``repro_torch.launch.reshard.ParamSwapper``, so an adopted plan re-lays-out
the training state on the plan's mesh (clamped onto the ranks of the process
group; one rank, one card, when the run is alone) and the reshard lands in
the trace and metrics.  ``--shift-at K`` switches the data mixture
single-image → video at step K to force a mid-run drift.

``--hosts N`` runs the loop *elastically*: the process group's ranks split
into N hosts owned by a ``repro_torch.launch.fleet.FleetManager``, each
global batch is drawn through a ``HostShardedSource`` with exactly-once
accounting, and ``--fail-host-at K`` / ``--revive-host-at K`` drive a
``FaultInjector`` that kills / revives the last host at those steps — the
controller recovers checkpoint-free (re-plan for the survivors + live
state migration).  It runs as one process a rank (gloo with ``--device
cpu``, NCCL on the cards); rank 0 runs the controller and shares each
step's items, plan and groups and every swapper call with the other ranks,
which make the same swapper calls; every step the ranks check that they
agree.  The state is replicated over the plan's mesh and every rank of it
trains the whole global batch (the per-host shard is bookkeeping, as in the
reference); a rank outside the mesh, a down host's among them, holds none
of the state and trains nothing.

    PYTHONPATH=src python -m repro_torch.train_mllm [--steps 200] [--random]
        [--trace build/runtime_trace.json] [--replan] [--shift-at 8]
        [--compose-window 2] [--ckpt build/runtime_ckpt]
    PYTHONPATH=src python -m repro_torch.train_mllm --tiny --device cpu --steps 8
    PYTHONPATH=src OMP_NUM_THREADS=1 python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.train_mllm --tiny --device cpu \
        --steps 8 --hosts 4 --fail-host-at 3 --revive-host-at 6

The model is fp32 throughout, so its attention takes the kernels' fp32
route; the plan is priced by the analytic H100 spec on 16 cards of 80 GB.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import math
import os
import struct
import sys
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_leaves
from repro_torch.common.types import MLLMConfig, ModalityStub, ModelConfig, resolve_device
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.space import ClusterSpec, ModuleParallelism, ParallelismPlan
from repro_torch.core.profiling.analytic import H100
from repro_torch.data.host_shard import HostShardedSource
from repro_torch.data.synthetic import MixedDataset
from repro_torch.launch.fleet import FaultInjector, FleetManager
from repro_torch.launch.reshard import ParamSwapper, Placed, clamped_plan_mesh
from repro_torch.models import mllm as mllm_lib
from repro_torch.models.model import FwdCtx
from repro_torch.runtime import DriftDetector, trace
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
                    help="enable background re-planning on drift, with "
                         "physical re-layout of the state on plan hot-swap")
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
    ap.add_argument("--hosts", type=int, default=0,
                    help="split the process group's ranks into this many "
                         "hosts and run elastically (0 = single host)")
    ap.add_argument("--fail-host-at", type=int, default=0,
                    help="kill the last host at this step (requires --hosts; "
                         "0 = no failure)")
    ap.add_argument("--revive-host-at", type=int, default=0,
                    help="revive the killed host at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if (args.fail_host_at or args.revive_host_at) and not args.hosts:
        ap.error("--fail-host-at/--revive-host-at need --hosts")
    if args.hosts and args.random:
        ap.error("--random bypasses the controller, so fleet recovery "
                 "(poll_fleet) would never run; drop one of the two flags")
    if args.hosts and args.compose_window:
        ap.error("--hosts draws through the per-host sharded source; "
                 "combine it with --compose-window is not supported yet")
    if args.random and args.replan:
        ap.error("--random bypasses the control loop (schedule_random "
                 "never reaches the controller), so --replan would only "
                 "adopt plans at exit; drop one of the two flags")
    return args


def _device(name) -> torch.device:
    """The run's device; under ``torch.distributed.run`` on the cards, the
    rank's own (``LOCAL_RANK``)."""
    dev = resolve_device(name)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          torch.cuda.current_device())))
        torch.cuda.set_device(dev)
    return dev


@contextlib.contextmanager
def _process_group(args, dev):
    """The run's process group: the caller's, one from the environment that
    ``torch.distributed.run`` sets, or, for a single-host run, a group of one
    rank of its own (NCCL on a card, gloo on the CPU).  ``--hosts`` needs
    ranks to split: it raises without a group.  Yields (rank, world size)."""
    own = not dist.is_initialized()
    if own:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timedelta(minutes=5))
        elif args.hosts:
            raise RuntimeError("--hosts runs one process a rank: start it under "
                               "torch.distributed.run, or initialise a process "
                               "group first")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    try:
        yield dist.get_rank(), dist.get_world_size()
    finally:
        if own:
            dist.destroy_process_group()


def _share(msg=None):
    """Rank 0's ``msg`` on every rank."""
    box = [msg]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class _Lead:
    """Rank 0's swapper: tells the other ranks of every call that builds a
    mesh or moves the state before it makes the call, so that every rank
    makes it (``_follow``)."""

    def __init__(self, swapper):
        self.swapper = swapper

    def compatible(self, old_plan, new_plan):
        _share(("compatible", old_plan, new_plan))
        return self.swapper.compatible(old_plan, new_plan)

    def swap(self, old_plan, new_plan):
        _share(("swap", old_plan, new_plan))
        return self.swapper.swap(old_plan, new_plan)

    def refresh(self, plan):
        _share(("refresh", plan))
        return self.swapper.refresh(plan)

    def estimate_cost_s(self, old_plan, new_plan):
        return self.swapper.estimate_cost_s(old_plan, new_plan)

    @property
    def damaged(self):
        return self.swapper.damaged


def _follow(swapper):
    """The other ranks' side of ``_Lead``: make rank 0's swapper calls, in
    its order, until it sends the step or the end (returned).  A failed call
    is rank 0's failure too (the same call on the same state), which its
    controller survives unless the swapper is damaged."""
    while True:
        msg = _share()
        if msg[0] in ("step", "done"):
            return msg
        if msg[0] == "error":
            raise RuntimeError(f"rank 0 stopped: {msg[1]}")
        try:
            getattr(swapper, msg[0])(*msg[1:])
        except Exception as e:             # noqa: BLE001 — as rank 0's controller
            if swapper.damaged:
                raise
            print(f"[rank {dist.get_rank()}] swapper.{msg[0]} failed: "
                  f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)


def _agree(k, out, fleet, state) -> None:
    """Raise unless every rank has the same step, plan, groups, roster and
    layout of the state."""
    mine = repr((k, out.plan.as_tuple(), [[int(i) for i in g] for g in out.groups],
                 fleet.devices() if fleet is not None else None,
                 state.layout if isinstance(state, Placed) else "whole"))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, hashlib.sha256(mine.encode()).hexdigest())
    if len(set(got)) != 1:
        raise RuntimeError(f"ranks disagree at step {k} on the plan, the groups, the "
                           f"roster or the state's layout; rank {dist.get_rank()}: {mine}")


def _agreed_loss(k, loss):
    """The training ranks' loss, which must be bitwise the same on each."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, loss)
    bits = {struct.pack("<d", x) for x in got if x is not None}
    if len(bits) != 1:
        raise RuntimeError(f"step {k}: the training ranks' losses differ: {got}")
    return next(x for x in got if x is not None)


def run(args, params=None, *, swapper_cls=ParamSwapper) -> dict:
    """The training loop of ``args`` (``parse_args``) on this rank; ``params``
    default to a seeded init on the device.  Returns the run: ``steps`` (per
    step the loss, the step's host seconds, the ``ScheduleOutput``, the items
    and whether a re-plan search was in flight while the step ran), the
    controller ``ctl`` (closed; None but on rank 0), this rank's final
    ``params`` and ``opt`` (empty tensors where it holds none of the state),
    the ``swapper`` (a ``swapper_cls``) and its ``state``, the ``train_step``,
    the last step's tensor ``batch`` and ``lr``, the steps this rank
    ``trained``, the peak device GiB (None on the CPU) and the loop's wall
    seconds."""
    dev = _device(args.device)
    with _process_group(args, dev) as (rank, world), \
            trace.recording(rank == 0 and bool(args.trace)):
        return _train(args, params, dev, rank, world, swapper_cls)


def _train(args, params, dev, rank, world, swapper_cls) -> dict:
    cuda = dev.type == "cuda"
    lead = rank == 0
    enc_cfg, llm_cfg, mcfg = tiny_configs() if args.tiny else (ENC, LLM, MCFG)
    if args.shift_at:
        ds = MixedDataset("single_image", seed=0, tokens_per_media_item=TPM)
        post_ds = MixedDataset("video", seed=1, tokens_per_media_item=TPM)
    else:
        ds = MixedDataset("mixed", seed=0, tokens_per_media_item=TPM)
        post_ds = None
    if params is None:
        params = mllm_lib.init(mcfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    if lead:
        print(f"[model] {n_params/1e6:.1f}M params  device={dev}  ranks={world}",
              flush=True)

    # The controller reaches the live (params, opt) state through this
    # holder: a plan hot-swap physically re-lays-out both (optimizer state
    # moves with the parameters) on the plan's mesh.
    live = {"state": (params, adamw_init(params))}
    del params
    fleet = injector = None
    if args.hosts:
        fleet = FleetManager(n_hosts=args.hosts, device_type=dev.type)
        schedule = {}
        victim = fleet.n_hosts - 1
        if args.fail_host_at:
            schedule[args.fail_host_at] = [("fail", victim)]
        if args.revive_host_at:
            schedule[args.revive_host_at] = [("join", victim)]
        injector = FaultInjector(fleet, schedule)
        if lead:
            print(f"[fleet] {fleet.n_hosts} hosts x {fleet.devices_per_host} ranks  "
                  f"schedule={schedule}", flush=True)
    swapper = swapper_cls(
        lambda: live["state"], lambda s: live.update(state=s),
        # fleet runs migrate onto the surviving roster; single-host runs
        # keep the rank-count clamp
        mesh_factory=(fleet.plan_mesh if fleet else
                      functools.partial(clamped_plan_mesh, device_type=dev.type)))
    ctl = hsrc = None
    current = {"ds": ds}
    if lead:
        eng = DFLOPEngine(llm_cfg=llm_cfg, enc_cfg=enc_cfg, e_seq_len=16,
                          cluster=CLUSTER, tokens_per_media_item=TPM,
                          objective=args.objective)
        eng.profile(ds)
        # tighter drift window than the default so a --shift-at demo fires
        # within a few global batches at GBS 16
        drift = DriftDetector(window=128, check_every=32, cooldown=64)
        ctl = eng.runtime(GBS, plan=LOCAL_PLAN, adaptive=True, ilp_time_limit_s=0.05,
                          auto_replan=args.replan, drift=drift,
                          param_swapper=swapper if world == 1 else _Lead(swapper),
                          compose_window=args.compose_window,
                          max_staleness=args.max_staleness or None, fleet=fleet,
                          trace=trace.recorder() if args.trace else True)
        if fleet is not None:
            hsrc = HostShardedSource(lambda: current["ds"].sample(GBS), GBS,
                                     fleet=fleet, keep_committed=False)

    lr_fn = cosine_lr(1e-3, warmup=20, total=args.steps)
    step = make_train_step(mcfg, AdamWConfig(lr=1e-3),
                           ctx=FwdCtx(mode="train", attn_impl="kernel"))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    losses, pred_cmax, steps, trained = [], [], [], []
    batch = None
    t0 = time.time()
    try:
        for k in range(args.steps):
            active_ds = post_ds if (post_ds and k >= args.shift_at) else ds
            trace.set_batch(k)
            if injector is not None:
                injector.on_step(k)      # roster mutates before this step draws
            if lead:
                if hsrc is not None:
                    current["ds"] = active_ds
                    hsrc.draw()          # per-host split over the alive roster
                    items = hsrc.in_flight
                elif ctl.composer is not None:
                    # refills the window to capacity (first call warms the
                    # full W-batch lookahead), then emits one composed batch
                    items = ctl.compose(draw=lambda: active_ds.sample(GBS))
                else:
                    items = active_ds.sample(GBS)
                out = (ctl.scheduler.schedule_random(items, seed=k) if args.random
                       else ctl.schedule(items))   # may physically swap `live`
                in_flight = ctl.replan_in_flight
                if world > 1:
                    _share(("step", items, out, in_flight))
            else:
                if fleet is not None:
                    fleet.poll_events()  # rank 0's controller drains its own
                _, items, out, in_flight = _follow(swapper)
            if world > 1:
                _agree(k, out, fleet, live["state"])
            pred_cmax.append(out.cmax)
            batch = as_tensors(build_batches(active_ds, out.plan, items, out.groups,
                                             out.plan.n_mb,
                                             vocab_size=llm_cfg.vocab_size),
                               device=dev)
            state = live["state"]
            placed = isinstance(state, Placed)
            loss, seconds, m = None, 0.0, None
            if ((not placed or state.layout.holds(rank))
                    and (fleet is None or fleet.host_of(rank).alive)):
                params, opt = state.tree if placed else state
                ts = time.perf_counter()
                params, opt, m = step(params, opt, batch, lr_fn(k))
                loss = m["loss"].item()
                if cuda:
                    torch.cuda.synchronize(dev)
                seconds = time.perf_counter() - ts
                live["state"] = state.with_tree((params, opt)) if placed else (params, opt)
                trained.append(k)
                del params, opt
            del state
            if world > 1:
                loss = _agreed_loss(k, loss)
            if lead:
                # traced: the step's idle device time is its wall time less
                # its device spans (none on the CPU: not measured, 0)
                dev_ms = trace.recorder().device_ms(batch=k) if args.trace else None
                idle = max(seconds - dev_ms / 1e3, 0.0) if dev_ms is not None else 0.0
                ctl.observe_step(out, seconds, idle_s=idle)
                if m is not None:
                    # NaN (no MoE layers) is skipped, not recorded
                    ctl.metrics.record_moe(float(m["moe_drop_rate"]),
                                           float(m["moe_imbalance"]))
                if hsrc is not None:
                    hsrc.commit()        # step survived: batch delivered once
            losses.append(loss)
            steps.append({"step": k, "loss": loss, "seconds": seconds,
                          "schedule": out, "items": items, "in_flight": in_flight})
            if lead and k % 25 == 0:
                print(f"step {k:4d}  loss={losses[-1]:.3f}  {seconds:.3f}s  "
                      f"pred C_max={out.cmax:.4f}s  solver={out.solver}", flush=True)
        dt = time.time() - t0
        if lead:
            _summary(args, ctl, fleet, hsrc, losses, pred_cmax, steps, dt)
            ctl.close()                  # a finished re-plan may still swap
            if world > 1:
                _share(("done",))
        else:
            _follow(swapper)
    except BaseException as e:
        if lead and world > 1:
            with contextlib.suppress(Exception):
                _share(("error", f"{type(e).__name__}: {e}"))
        raise
    state = live["state"]
    params, opt = state.tree if isinstance(state, Placed) else state
    if world > 1:
        print(f"[losses] rank {rank} trained {trained} holds "
              f"{state.local_bytes() if isinstance(state, Placed) else 'all'} bytes "
              f"losses {losses!r}", flush=True)
    if lead and args.trace:
        print(f"chrome trace written to {ctl.export_trace(args.trace)}")
    if lead and args.ckpt:
        checkpoint.save(args.ckpt, params, {"steps": args.steps, "loss": losses[-1]})
        print(f"checkpoint written to {args.ckpt}")
    return {"steps": steps, "ctl": ctl, "params": params, "opt": opt,
            "swapper": swapper, "state": state, "fleet": fleet, "trained": trained,
            "train_step": step, "batch": batch, "lr": lr_fn(args.steps - 1),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else None,
            "wall_s": dt, "cfg": mcfg}


def _summary(args, ctl, fleet, hsrc, losses, pred_cmax, steps, dt) -> None:
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
    if fleet is not None:
        fl = snap["fleet"]
        print(f"[fleet] hosts={fleet.n_alive}/{fleet.n_hosts}  "
              f"failures={fl['n_host_failures']}  "
              f"joins={fl['n_host_joins']}  "
              f"recoveries={fl['n_recoveries']}  "
              f"degraded={fl['n_degraded']}  "
              f"committed={hsrc.n_committed}  aborted={hsrc.n_aborted}")
    if ctl.composer is not None:
        print(f"[compose] batches={snap['n_composed']}  "
              f"pred_gain_mean={fmt('compose_pred_gain_mean', 1.0, '.3f')}  "
              f"forced_items={snap['n_forced_items']}  "
              f"overhead={fmt('compose_elapsed_mean_s', 1e3, '.2f')}ms")


def main(argv=None) -> int:
    r = run(parse_args(argv))
    if not all(math.isfinite(s["loss"]) for s in r["steps"]):
        raise SystemExit("non-finite loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
