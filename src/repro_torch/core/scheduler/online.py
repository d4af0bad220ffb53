"""Online Microbatch Scheduler (paper §3.4).

Per global batch: predict per-item (E_dur, L_dur) from the profiled models
under the active plan θ*, partition the N items into m = N_mb · L_dp buckets
with the hybrid exact-then-LPT solver, and hand the index groups to the data
loader.  Runs asynchronously on host CPU — batch t+1 is scheduled while step
t computes (§3.4.2: "the scheduler operates asynchronously to eliminate
scheduling overhead").  The asynchronous path's branch-and-bound runs in the
scheduler's own child process (``search_worker``), so it never holds this
process's interpreter lock while the step packs and launches; ``schedule()``
searches in the caller's thread.
"""
from __future__ import annotations

import concurrent.futures
import time
import weakref
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.common import trace
from repro_torch.core.optimizer.objective import corrected_item_durations
from repro_torch.core.optimizer.space import ParallelismPlan
from repro_torch.core.profiling.model_profiler import PerfModel
from repro_torch.core.scheduler.adaptive import AdaptiveCorrection
from repro_torch.core.scheduler.ilp import solve_makespan_bnb
from repro_torch.core.scheduler.lpt import cmax, lower_bound, lpt_schedule
from repro_torch.core.scheduler.search_worker import SearchWorker
from repro_torch.data.items import DataItem


@dataclass
class ScheduleOutput:
    groups: List[List[int]]          # m index groups over the global batch
    cmax: float                      # predicted bottleneck duration
    lower_bound: float
    solver: str                      # "ilp" | "lpt" | "ilp-timeout"
    elapsed_s: float
    e_dur: np.ndarray
    l_dur: np.ndarray
    plan: Optional[ParallelismPlan] = None   # plan θ this batch was balanced for

    @property
    def imbalance(self) -> float:
        """Relative gap to the load lower bound (<1% at GBS 2048, Fig. 16b)."""
        return self.cmax / max(self.lower_bound, 1e-12) - 1.0

    @property
    def step_makespan(self) -> float:
        """Pipeline-makespan estimate (N_mb + bubble_slots) · cmax —
        comparable across plans with different bucket counts *and* schedule
        families, unlike raw cmax.  cmax is the solver's bucket bottleneck
        over `_solver_durations`, i.e. already the per-slot cost of the
        plan's own family (combined serial cost under encoder_fill)."""
        if self.plan is None:
            return self.cmax
        return (self.plan.n_mb + self.plan.bubble_slots) * self.cmax


def _solver_durations(plan: Optional[ParallelismPlan], e_dur: np.ndarray,
                      l_dur: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-item durations the balancing solver should weigh.

    For the staged families a bucket costs max(ΣE, ΣL) — encoder and LLM
    stages run on *different* ranks, so the solver balances the two module
    loads independently.  Under ``encoder_fill`` the encoder chunk (its full
    duration split over the L_pp replicas) runs *serially* with the LLM
    stage on the same ranks, so the bucket cost is the combined sum — pass
    it as both module loads and max(Σc, Σc) degenerates to Σc."""
    if plan is not None and plan.schedule == "encoder_fill":
        comb = l_dur + e_dur / plan.llm.pp
        return comb, comb
    return e_dur, l_dur


class OnlineMicrobatchScheduler:
    def __init__(self, plan: ParallelismPlan, perf: PerfModel,
                 tokens_per_media_item: int, *,
                 ilp_time_limit_s: float = 0.25,
                 adaptive: Optional[AdaptiveCorrection] = None,
                 calibration=None,
                 mode: str = "train"):
        """calibration: optional duck-typed refiner with
        ``correct(module, shape, tp, predicted)`` / ``observe(module, shape,
        tp, predicted, actual)`` (see repro.runtime.calibration)."""
        self.plan = plan
        self.perf = perf
        self.tpm = tokens_per_media_item
        self.ilp_time_limit_s = ilp_time_limit_s
        self.adaptive = adaptive
        self.calibration = calibration
        self.mode = mode
        # roster_chips: chips the fleet can actually field right now (None
        # = single-host, no roster tracking).  Elastic runs shrink it on
        # host loss so a plan sized for the old fleet is rejected loudly
        # instead of silently over-subscribing the survivors.
        self.roster_chips: Optional[int] = None
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None
        self._worker: Optional[SearchWorker] = None   # started by the first submit()

    # ------------------------------------------------------------------ #
    @property
    def n_buckets(self) -> int:
        return self.plan.n_buckets

    def set_roster(self, n_chips: Optional[int]) -> None:
        """Update the fleet capacity the scheduler plans against (None
        disables the check).  The *current* plan is left untouched — the
        controller's recovery path decides what to run on the survivors;
        only future `set_plan()` calls validate against the new roster."""
        self.roster_chips = None if n_chips is None else int(n_chips)

    def set_plan(self, plan: ParallelismPlan) -> None:
        """Hot-swap the active plan θ*.  Takes effect on the next
        `schedule()` call — in-flight work keeps the plan it was scheduled
        under (each call captures `self.plan` once on entry).  With a
        roster attached (`set_roster`), a plan needing more chips than the
        fleet can field is rejected."""
        if self.roster_chips is not None and plan.chips > self.roster_chips:
            raise ValueError(
                f"plan needs {plan.chips} chips but the roster has "
                f"{self.roster_chips}; re-plan for the surviving fleet")
        self.plan = plan

    def item_durations(self, items: Sequence[DataItem],
                       plan: Optional[ParallelismPlan] = None) -> tuple[np.ndarray, np.ndarray]:
        """Predicted per-item stage durations under θ* (§3.4.2 step 1).

        Delegates to the duration path shared with the optimizer's sampling
        objectives (`objective.corrected_item_durations`), so search-time
        Monte-Carlo and schedule-time predictions agree on identical shapes
        by construction."""
        plan = plan if plan is not None else self.plan
        b = np.array([it.encoder_batch() for it in items], np.float64)
        s = np.array([it.llm_seq_len(self.tpm) for it in items], np.float64)
        return corrected_item_durations(self.perf, plan, b, s,
                                        mode=self.mode,
                                        adaptive=self.adaptive,
                                        corrector=self.calibration)

    # ------------------------------------------------------------------ #
    def schedule(self, items: Sequence[DataItem],
                 batch: Optional[int] = None) -> ScheduleOutput:
        """Search in the caller's thread.  ``batch``: the global batch's
        index, for its ``sched.schedule`` span (else the calling thread's
        ``trace.set_batch``)."""
        return self._schedule(items, batch, None)

    def _schedule(self, items: Sequence[DataItem], batch: Optional[int],
                  worker: Optional[SearchWorker]) -> ScheduleOutput:
        """The search in ``worker`` (the asynchronous path) or, without one,
        in this thread, inside its ``sched.schedule`` span."""
        with trace.span("sched.schedule", cat="scheduler", batch=batch,
                        items=len(items)) as sp:
            t0 = time.monotonic()
            plan = self.plan                 # capture once: hot-swap safe
            e_dur, l_dur = self.item_durations(items, plan)
            m = plan.n_buckets
            se, sl = _solver_durations(plan, e_dur, l_dur)
            if worker is None:
                res = solve_makespan_bnb(se, sl, m, time_limit_s=self.ilp_time_limit_s)
            else:
                res = worker.solve(se, sl, m, self.ilp_time_limit_s)
            if res.timed_out:
                # hybrid contract: on timeout the incumbent is the LPT solution
                # possibly improved by partial search — keep the better one.
                solver = "ilp-timeout"
            else:
                solver = "ilp"
            lb = lower_bound(se, sl, m)
            out = ScheduleOutput(res.groups, res.cmax, lb, solver,
                                 time.monotonic() - t0, e_dur, l_dur, plan)
            sp.set(buckets=len(out.groups), solver=out.solver, elapsed_s=out.elapsed_s,
                   where="thread" if worker is None else "worker", nodes=res.nodes)
        return out

    def schedule_random(self, items: Sequence[DataItem],
                        seed: int = 0) -> ScheduleOutput:
        """Data-agnostic baseline: random assignment (what PyTorch/Megatron
        loaders do) — used in Fig. 4/13 comparisons."""
        t0 = time.monotonic()
        plan = self.plan
        e_dur, l_dur = self.item_durations(items, plan)
        m = plan.n_buckets
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(items))
        groups: List[List[int]] = [[] for _ in range(m)]
        for pos, i in enumerate(perm):
            groups[pos % m].append(int(i))
        se, sl = _solver_durations(plan, e_dur, l_dur)
        return ScheduleOutput(groups, cmax(se, sl, groups),
                              lower_bound(se, sl, m), "random",
                              time.monotonic() - t0, e_dur, l_dur, plan)

    # ------------------------------------------------------------------ #
    # Asynchronous operation: schedule batch t+1 while step t runs.
    def submit(self, items: Sequence[DataItem], batch: Optional[int] = None) -> None:
        """Schedule ``items`` on the pool's thread, which hands the search
        to the scheduler's worker process and waits for it off the
        interpreter lock; the worker starts here once, and ends when the
        scheduler is collected or the interpreter exits."""
        if self._pending is not None:
            raise RuntimeError(
                "submit() called with a schedule still pending; "
                "collect() the previous batch first")
        if self._worker is None:
            self._worker = SearchWorker()
            weakref.finalize(self, self._worker.close)
        self._pending = self._pool.submit(self._schedule, list(items), batch, self._worker)

    def collect(self) -> Optional[ScheduleOutput]:
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        return pending.result()          # a search's error, or its worker's, raises here

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    # ------------------------------------------------------------------ #
    def observe(self, module: str, shape: float, predicted: float,
                actual: float,
                plan: Optional[ParallelismPlan] = None) -> None:
        """Runtime feedback for Adaptive Correction + online calibration.

        `plan`: the plan the measured batch was scheduled under (defaults to
        the current one) — after a hot-swap, pass `ScheduleOutput.plan` so
        calibration keys the measurement to the TP degree it ran at.
        The calibrator observes the residual left *after* adaptive
        correction, mirroring the order item_durations() applies them —
        otherwise both learn the same ratio and compound to its square."""
        adjusted = predicted
        if self.adaptive is not None:
            self.adaptive.observe(module, shape, predicted, actual)
            adjusted = self.adaptive.correct(module, shape, predicted)
        if self.calibration is not None:
            plan = plan if plan is not None else self.plan
            mp = plan.encoder if module == "encoder" else plan.llm
            if mp is not None:
                self.calibration.observe(module, shape, mp.tp, adjusted,
                                         actual)
