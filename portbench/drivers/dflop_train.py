"""The DFLOP training loop on one card, as the port's quickstart runs it:
``DFLOPEngine.profile`` -> ``plan`` -> ``scheduler`` -> ``ScheduledLoader``
-> ``make_train_step``, driven by a traffic mix and checked against the
plain references.

One run: set-up (the port's import and kernel libraries, the weights made
on the card from the seed, profile and plan, then three steps through the
window's own loader and step, the first two of which the reference follows),
the measured window (closed loop: the next step starts when the last one
has synchronized; a number of steps fixed for the cell), with ``trace`` a
few steps more under ``torch.profiler``, and then the check, once the
program's state is freed.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import itemgen, weights
from portbench.dims import Dims, dims
from portbench.core import load_module

SETUP_STEPS = 3          # steps before the window: the check's, then warm-up
CHECK_STEPS = 2          # the steps the reference follows (two for three: the
                         # reference then ends inside the window's length)
TRACE_STEPS = 2          # steps under the profiler in a traced run
# the cluster the plan is priced for: the quickstart's node of eight H100s
CLUSTER_CHIPS = 8


def _port_config(cfg: dict, m: Dims):
    from repro_torch.common.types import ModelConfig
    return ModelConfig(name=cfg["name"], family="dense", n_layers=m.layers, d_model=m.d,
                       n_heads=m.heads, n_kv_heads=m.kv_heads, head_dim=m.head_dim,
                       d_ff=m.d_ff, vocab_size=m.vocab, activation="swiglu",
                       rope_theta=m.rope_theta, norm_eps=m.eps, dtype=m.compute_dtype,
                       param_dtype=m.param_dtype)


class Program:
    """The system under test, set up for one run: the planner, the scheduled
    loader over the mix's items and the train step over the seed's weights."""

    def __init__(self, cell: dict, seed: int, device, fault: str | None = None):
        from repro_torch.core.engine import DFLOPEngine
        from repro_torch.core.optimizer.space import (ClusterSpec, ModuleParallelism,
                                                      ParallelismPlan)
        from repro_torch.core.profiling.analytic import H100
        from repro_torch.data.items import DataItem
        from repro_torch.data.loader import ScheduledLoader
        from repro_torch.models.model import FwdCtx
        from repro_torch.train import optim, step

        self.seed, self.dev = seed, torch.device(device)
        cfg, tr = cell["config"], cell["traffic"]
        self.m = dims(cfg)
        self.mc = _port_config(cfg, self.m)
        self.tpm = cfg["tokens_per_media_item"]
        self.opt_cfg = cfg["optimizer"]
        self.n_mb = tr["microbatches"]

        def to_item(it):
            return DataItem(it.n_media, it.text, it.modality, it.item_id)

        t0 = time.perf_counter()
        cluster = ClusterSpec(n_chips=CLUSTER_CHIPS, chips_per_node=CLUSTER_CHIPS,
                              mem_bytes=H100.mem_bytes, name="h100-sxm")
        self.engine = DFLOPEngine(llm_cfg=self.mc, cluster=cluster,
                                  tokens_per_media_item=self.tpm)
        self.engine.profile(items=[to_item(it) for it in itemgen.profile_items(tr)])
        self.plan = self.engine.plan(gbs=tr["plan_items_per_step"])
        self.plan_s = time.perf_counter() - t0
        self.sched = self.engine.scheduler(
            plan=ParallelismPlan(llm=ModuleParallelism(1, 1, 1), n_mb=self.n_mb),
            adaptive=True, ilp_time_limit_s=tr["ilp_time_limit_s"])
        self.stream = itemgen.StepStream(tr, seed, to_item)
        self.loader = ScheduledLoader(None, self.sched, gbs=tr["items_per_step"],
                                      token_budget=tr["token_budget"],
                                      vocab_size=self.m.vocab, seed=abs(int(seed)),
                                      item_source=self.stream)
        self.batches = iter(self.loader)
        self.params = weights.port_tree(self.m, weights.make(self.m, seed, self.dev))
        self.opt = optim.adamw_init(self.params)
        self.step_fn = step.make_train_step(self.mc, optim.AdamWConfig(**self.opt_cfg),
                                            ctx=FwdCtx())
        if fault == "no_decay":
            self.step_fn = step.make_train_step(
                self.mc, optim.AdamWConfig(**{**self.opt_cfg, "weight_decay": 0.0}),
                ctx=FwdCtx())
        elif fault is not None:
            self.step_fn = _faulty(fault, self.step_fn, step.make_loss_fn(self.mc, FwdCtx()))
        self.as_tensors = step.as_tensors
        self.loaded: list[dict] = []     # every batch the loader handed out
        self.losses: list = []

    def step(self) -> dict:
        """One step through the loader and the train step, ending in a
        device synchronize: its record."""
        t0 = time.perf_counter()
        with record_function("portbench.next_batch"):
            batch = next(self.batches)
        t1 = time.perf_counter()
        with record_function("portbench.train_step"):
            self.params, self.opt, met = self.step_fn(
                self.params, self.opt, self.as_tensors(batch, device=self.dev),
                self.opt_cfg["lr"])
        with record_function("portbench.synchronize"):
            _sync(self.dev)
        t2 = time.perf_counter()
        rec = {"wait_s": t1 - t0, "seconds": t2 - t1, "segment_ids": batch["segment_ids"]}
        self.loaded.append({"batch": batch, "groups": self.loader.last_schedule.groups,
                            "truncated": self.loader.last_truncated})
        self.losses.append(met["loss"].detach())
        return rec

    def named(self, tree) -> dict:
        from repro_torch.common.pytree import tree_paths
        return {weights.leaf_name(p): t for p, t in tree_paths(tree)}

    def check_steps(self) -> dict:
        """The set-up steps.  Of the first CHECK_STEPS, what the comparison
        reads: each step's loss, the first gradient as AdamW took it (its
        first moment after one step over 1 - b1) and each leaf's change
        after the last of them (``change_stats``); the rest warm up."""
        out = {"grad1": {}}
        for k in range(SETUP_STEPS):
            self.step()
            if k == 0:
                out["grad1"] = {n: float(torch.linalg.vector_norm(t)) / (1 - self.opt_cfg["b1"])
                                for n, t in self.named(self.opt["m"]).items()}
            if k == CHECK_STEPS - 1:
                out.update(change_stats(self.m, self.seed, self.dev,
                                        self.named(self.params), self.named(self.opt["m"])))
        out["losses"] = [float(x) for x in self.losses[:CHECK_STEPS]]
        return out

    def close(self):
        self.sched._pool.shutdown(wait=True)
        for name in ("params", "opt", "step_fn", "batches", "loader", "engine"):
            setattr(self, name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _faulty(fault: str, step_fn, loss_fn):
    """A train step with a fault planted under the harness: ``unchanged``
    returns its state as it came (the loss of the batch, no update);
    ``half_batch`` trains on the first half of the microbatches, their mean;
    ``ascent`` steps up the gradient (and grows the weights: the rate's
    sign turned).  ``no_decay``, AdamW without its weight decay, is made in
    ``Program``."""
    if fault == "ascent":
        def ascent(params, opt, batch, lr):
            return step_fn(params, opt, batch, -lr)
        return ascent
    if fault == "half_batch":
        def half(params, opt, batch, lr):
            n = next(iter(batch.values())).shape[0] // 2
            return step_fn(params, opt, {k: v[:n] for k, v in batch.items()}, lr)
        return half
    if fault == "unchanged":
        def unchanged(params, opt, batch, lr):
            n = next(iter(batch.values())).shape[0]
            with torch.no_grad():
                loss = sum(loss_fn(params, {k: v[i] for k, v in batch.items()})
                           for i in range(n)) / n
            return params, opt, {"loss": loss}
        return unchanged
    raise ValueError(f"unknown fault {fault!r}")


def change_stats(m: Dims, seed: int, dev, params: dict, moment: dict) -> dict:
    """Each leaf's change d = p - p0 (p0 made again group by group from the
    seed): ``update`` ||d||; ``decay`` <d, p0>, which weight decay sets
    (the step's own part lies nearly across p0); ``descent`` <d, m>, m the
    first moment, which the step's direction sets."""
    out = {"update": {}, "decay": {}, "descent": {}}
    with torch.no_grad():
        for g, _ in weights.groups(m):
            p0 = weights.make_group(m, seed, dev, g)
            for name, t0 in p0.items():
                d = params[name].float() - t0
                out["update"][name] = float(torch.linalg.vector_norm(d))
                out["decay"][name] = float(torch.sum(d * t0))
                out["descent"][name] = float(torch.sum(d * moment[name].float()))
                del d
            del p0
    return out


def window(prog: Program, seconds: float, pace_s: float) -> dict:
    """The measured window: ``round(seconds / pace_s)`` whole steps, the
    pace fixed in the cell's file, so that every run of the cell trains the
    same steps however fast the program is (the mix's steps differ in real
    tokens, and a count that followed the program's speed would gain or lose
    one of them).  Its time runs from the first step's start to the last
    step's synchronize; peak memory is taken over it."""
    dev = prog.dev
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    first = len(prog.losses)
    n = max(1, round(seconds / pace_s))
    t0 = time.perf_counter()
    steps = [prog.step() for _ in range(n)]
    t_end = time.perf_counter()
    losses = torch.stack(prog.losses[first:]).float().cpu()
    return {"seconds": t_end - t0, "steps": steps,
            "failed": int((~torch.isfinite(losses)).sum()),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}


def traced(prog: Program, n: int) -> dict:
    """``n`` more steps under ``torch.profiler``: every device operation
    (name, start, end in seconds), the host's operations, and the traced
    span (the steps from the first batch to the last synchronize)."""
    from torch.profiler import ProfilerActivity, profile
    _sync(prog.dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("portbench.traced_steps"):
            recs = [prog.step() for _ in range(n)]
    events = list(prof.events())
    span = [e for e in events if e.name == "portbench.traced_steps"
            and e.device_type == torch.autograd.DeviceType.CPU]
    dev_ops, host_ops = [], []
    for e in events:
        tr = (e.time_range.start / 1e6, e.time_range.end / 1e6)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and e.name != "portbench.traced_steps":
                dev_ops.append((e.name, *tr))
        else:
            host_ops.append((e.name, *tr))
    if not span or not dev_ops:
        return {"steps": recs, "device_ops": [], "host_ops": host_ops, "span": None}
    s = span[0].time_range
    return {"steps": recs, "device_ops": dev_ops, "host_ops": host_ops,
            "span": (s.start / 1e6, s.end / 1e6)}


# --------------------------------------------------------------------------- #
# The check
# --------------------------------------------------------------------------- #
def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(|ref| of the leaf, the median
    leaf's |ref|), for a norm or an inner product a leaf."""
    med = statistics.median(abs(v) for v in ref.values())
    names = [k for k in ref if keep is None or keep(k)]
    return max(abs(prog[k] - ref[k]) / max(abs(ref[k]), med, 1e-30) for k in names)


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf's gap of the first gradient's norm, and of the change's
    ``update``, ``decay`` and ``descent`` after the check steps, leaving out
    leaves whose reference gradient is under a thousandth of the median
    leaf's (they move by round-off alone)."""
    g_med = statistics.median(ref["grad1"].values())
    moved = lambda k: ref["grad1"][k] >= 1e-3 * g_med  # noqa: E731
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad1": worst_leaf_gap(prog["grad1"], ref["grad1"]),
        **{k: worst_leaf_gap(prog[k], ref[k], keep=moved) for k in ("update", "decay", "descent")},
    }


def data_check(cell: dict, seed: int, draws: list, loaded: list) -> tuple[int, list, str]:
    """Every loaded batch against the reference packer, in the order the
    loader packed them: (mismatched steps, the reference's batches, the
    first fault)."""
    packer_mod = load_module("references", "packer")
    cfg, tr = cell["config"], cell["traffic"]
    packer = packer_mod.Packer(abs(int(seed)), tr["token_budget"], cfg["vocab_size"],
                               cfg["tokens_per_media_item"])
    bad, first, ref_batches = 0, "", []
    for k, rec in enumerate(loaded):
        dp = np.asarray(rec["batch"]["tokens"]).shape[1]
        want, trunc, fault = packer.step(draws[k], rec["groups"], tr["microbatches"], dp)
        if not fault:
            fault = packer_mod.mismatch(rec["batch"], want)
        if not fault and trunc != rec["truncated"]:
            fault = f"truncated {rec['truncated']} != {trunc}"
        if fault:
            bad += 1
            first = first or f"step {k}: {fault}"
        ref_batches.append(want)
    return bad, ref_batches, first


def reference_readings(cell: dict, seed: int, batches: list, device, *, compute=None,
                       state=None, fault=None) -> dict:
    """The plain reference (or, at a lower precision, the control) over the
    check steps' batches, from the same weights made again from the seed."""
    ref = load_module("references", cell["config"]["reference"])
    m = dims(cell["config"])
    dev = torch.device(device)
    w0 = weights.make(m, seed, dev)
    sizes = {"layers": m.layers, "eps": m.eps, "rope_theta": m.rope_theta}
    out = ref.train(w0, sizes, batches, cell["config"]["optimizer"],
                    compute=compute or torch.float32, state=state or torch.float32,
                    fault=fault)
    del w0
    out.update(change_stats(m, seed, dev, out.pop("params"), out.pop("moment")))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_start: float | None = None, fault: str | None = None) -> dict:
    """One benchmark run of a training cell: its record (end-to-end
    numbers, what the per-layer readers read, the check)."""
    t_start = time.perf_counter() if t_start is None else t_start
    prog = Program(cell, seed, device, fault)
    t_built = time.perf_counter()
    readings = prog.check_steps()
    dev = prog.dev
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    t_window = time.perf_counter()
    win = window(prog, seconds, cell["window_pace_s"])
    tr = traced(prog, TRACE_STEPS) if trace else None
    draws, loaded = prog.stream.drawn, prog.loaded
    plan, prog_plan_s = prog.plan, prog.plan_s
    prog.close()
    del prog
    n_tokens = sum(int((np.asarray(s["segment_ids"]) > 0).sum()) for s in win["steps"])
    record = {
        "dims": dims(cell["config"]), "window": win, "trace": tr,
        "end_to_end": {"train_tokens_per_s": n_tokens / win["seconds"],
                       "setup_s": t_window - t_start},
        "setup_parts": {"to_program": t_built - t_start - prog_plan_s, "plan": prog_plan_s,
                        "setup_steps": t_window - t_built},
        "attempted": len(win["steps"]), "failed": win["failed"],
        "peak_bytes": max(x for x in (setup_peak, win["peak_bytes"]) if x is not None)
        if dev.type == "cuda" else None,
        "plan": {"theta": str(plan.plan.as_tuple()) if plan.plan else None,
                 "makespan_s": plan.makespan},
    }
    # the check, with the program's state freed
    t_check = time.perf_counter()
    bad, ref_batches, first = data_check(cell, seed, draws, loaded)
    checks = {"data": float(bad)}
    notes = [first] if first else []
    if all(b is not None for b in ref_batches[:CHECK_STEPS]):
        ref = reference_readings(cell, seed, ref_batches[:CHECK_STEPS], dev)
        checks.update(compare(readings, ref))
        record["readings"] = {"program": readings, "reference": ref}
    else:
        checks.update(dict.fromkeys(("loss", "grad1", "update", "decay", "descent"), math.inf))
    record["checks"], record["notes"] = checks, notes
    record["check_s"] = time.perf_counter() - t_check
    return record
