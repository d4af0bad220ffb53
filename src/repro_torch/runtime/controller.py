"""RuntimeController: the closed profile → plan → schedule → observe →
re-plan control loop.

Wraps a `DFLOPEngine` and its `OnlineMicrobatchScheduler`:

  * every global batch flows through ``schedule()``, which feeds the
    observed shapes to the drift detector and the rolling metrics, and
    records trace spans;
  * measured durations come back through ``observe()`` /
    ``observe_step()``, refining predictions via `OnlineCalibrator` (and
    the paper's `AdaptiveCorrection`) and feeding residual drift;
  * when drift fires, `ParallelismOptimizer.search()` re-runs in a
    background thread over the *recent* shape window; the resulting plan
    is hot-swapped between global batches iff its predicted makespan
    beats the stale plan's by ``min_improvement``.

The swap is deliberately confined to batch boundaries: `schedule()` polls
the background future before scheduling, so in-flight microbatches always
complete under the plan they were balanced for.

Background searches score candidates (and the stale incumbent — same
objective, same calibrator, same seed) through the batched Monte-Carlo
path: per candidate, one vectorized LPT partition and one
`simulate_1f1b_batch` wavefront over every (trial, dp-rank) instance, at
any GBS — which is what keeps high-frequency re-planning affordable
(docs/simulator.md).
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.optimizer.objective import get_objective
from repro_torch.core.optimizer.search import ParallelismOptimizer, SearchResult
from repro_torch.core.profiling.data_profiler import ShapeDistribution
from repro_torch.core.scheduler.online import OnlineMicrobatchScheduler, ScheduleOutput
from repro_torch.data.items import DataItem
from repro_torch.runtime.calibration import OnlineCalibrator
from repro_torch.runtime.drift import DriftDetector, DriftEvent
from repro_torch.runtime.metrics import RuntimeMetrics
from repro_torch.runtime.trace import TraceRecorder


@dataclass
class ReplanRecord:
    trigger: DriftEvent
    stale_makespan: float       # current plan evaluated on the drifted dist
    new_makespan: float         # best plan found (inf when none feasible)
    swapped: bool
    search_elapsed_s: float
    plan_tuple: Optional[tuple] = None
    gated: Optional[str] = None     # why a better plan was NOT adopted
    reshard: Optional[object] = None  # ReshardReport of the physical swap


@dataclass
class RecoveryRecord:
    """One checkpoint-free roster recovery (`poll_fleet`): the membership
    events it coalesced, what plan survived, and how."""

    events: tuple                   # MembershipEvents drained together
    n_chips: int                    # roster capacity after the events
    old_plan_tuple: tuple
    new_plan_tuple: Optional[tuple]  # adopted plan (None = kept the old θ*)
    adopted: bool                   # a fresh search result was adopted
    degraded: bool                  # fell back: re-placed/stale old plan
    elapsed_s: float
    reshard: Optional[object] = None   # ReshardReport of the migration
    error: Optional[str] = None        # first search/reshard failure seen


class RuntimeController:
    def __init__(self, engine, scheduler: OnlineMicrobatchScheduler,
                 gbs: int, *,
                 trace: Optional[TraceRecorder] = None,
                 metrics: Optional[RuntimeMetrics] = None,
                 calibration: Optional[OnlineCalibrator] = None,
                 drift: Optional[DriftDetector] = None,
                 auto_replan: bool = True,
                 min_improvement: float = 0.02,
                 replan_n_trials: int = 8,
                 param_swapper=None,
                 swap_horizon_batches: int = 50,
                 composer=None,
                 fleet=None):
        """param_swapper: optional physical-reshard hook (duck-typed to
        `repro_torch.launch.reshard.ParamSwapper`: ``swap(old_plan, new_plan) ->
        ReshardReport`` plus optional ``estimate_cost_s``/``compatible``).
        When set, `maybe_swap()` re-lays-out the live params at the batch
        boundary and only adopts a plan whose predicted per-batch makespan
        advantage, amortized over ``swap_horizon_batches``, exceeds the
        measured/estimated reshard cost.

        composer: optional `repro.data.composer.LookaheadComposer`.  The
        controller wires its telemetry (compose spans + counters land in
        this trace/metrics) and flushes its cached window durations on
        every plan hot-swap, so composition never targets a stale θ*.

        fleet: optional `repro_torch.launch.fleet.FleetManager`.  `poll_fleet()`
        (called from `schedule()` at every batch boundary; physically-
        backed pipelined loops call it alongside `maybe_swap()`) drains
        its membership events and runs checkpoint-free recovery: re-plan
        for the new roster, migrate live params through `param_swapper`,
        degrade to the surviving roster when either fails (docs/fleet.md).
        Background re-plans are additionally gated on roster capacity so
        a search raced by a host loss can never adopt an over-sized plan."""
        self.engine = engine
        self.scheduler = scheduler
        self.gbs = gbs
        self.param_swapper = param_swapper
        self.swap_horizon_batches = swap_horizon_batches
        self.composer = composer
        self.fleet = fleet
        self.recoveries: List[RecoveryRecord] = []
        if fleet is not None:
            scheduler.set_roster(fleet.n_chips)
        self._pending_items: Optional[list] = None
        self.trace = trace if trace is not None else TraceRecorder(enabled=False)
        self.metrics = metrics if metrics is not None else RuntimeMetrics()
        self.calibration = calibration
        self.drift = drift if drift is not None else DriftDetector()
        self.auto_replan = auto_replan
        self.min_improvement = min_improvement
        self.replan_n_trials = replan_n_trials
        self.replans: List[ReplanRecord] = []
        self.batch_idx = 0
        self._replan_seed = 0     # varies per search; see _on_drift
        if calibration is not None:
            scheduler.calibration = calibration
        if engine.dist is not None:
            self.drift.set_reference(engine.dist)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="dflop-replan")
        self._replan_future: Optional[concurrent.futures.Future] = None
        self._lock = threading.Lock()
        self.trace.name_thread(0, "control-loop")
        self.trace.name_thread(1, "replan-search")
        if composer is not None:
            composer.trace = self.trace
            composer.metrics = self.metrics

    # ------------------------------------------------------------------ #
    @property
    def plan(self):
        return self.scheduler.plan

    def schedule(self, items: Sequence[DataItem]) -> ScheduleOutput:
        """Schedule one global batch through the control loop."""
        self.poll_fleet()                   # roster changes outrank re-plans
        self.maybe_swap()                   # adopt a finished re-plan first
        with self.trace.span("schedule", cat="scheduler",
                             batch=self.batch_idx, n_items=len(items)):
            out = self.scheduler.schedule(items)
        self.metrics.record_schedule(out)
        self.trace.counter("imbalance", out.imbalance)
        self.trace.counter("pred_cmax_s", out.cmax)
        ev = self.drift.observe_items(items, self.scheduler.tpm)
        if ev is not None:
            self._on_drift(ev)
        self.batch_idx += 1
        return out

    def compose(self, items: Optional[Sequence[DataItem]] = None, *,
                draw=None):
        """Emit the next composed global batch (requires a ``composer``).

        ``draw``: a zero-arg callable returning one global batch of
        items — the canonical per-step form.  It refills the window to
        capacity before composing, so the very first call warms the full
        ``window·gbs`` lookahead and every subsequent call draws exactly
        one batch: ``ctl.compose(draw=lambda: ds.sample(gbs))``.

        ``items``: push one pre-drawn cohort instead.  With this form
        the caller owns the warm-up — composing per-step from an
        initially empty window degenerates to FIFO with zero lookahead
        (each compose sees exactly the cohort just pushed), so a
        ``compose-cold-window`` trace instant marks any compose below
        capacity."""
        comp = self.composer
        if comp is None:
            raise RuntimeError("no composer attached; pass composer= (or "
                               "engine.runtime(compose_window=...))")
        if draw is not None:
            while not comp.ready:
                comp.push(draw())
        if items is not None:
            comp.push(items)
        if not comp.ready:
            self.trace.instant("compose-cold-window", cat="compose",
                               args={"pending": comp.pending,
                                     "capacity": comp.capacity})
        return comp.compose()

    # Pipelined variant mirroring the scheduler's submit/collect pair.
    # Telemetry parity with schedule(): the span/counters/drift feed all
    # happen at collect() time, when the batch's ScheduleOutput exists —
    # feeding drift at submit() would run the drift window one batch ahead
    # of the metrics stream.
    def submit(self, items: Sequence[DataItem]) -> None:
        """Schedule a batch asynchronously (batch t+1 while step t runs).

        With a `param_swapper`, plan adoption is NOT attempted here:
        submit() runs concurrently with the previous training step, and a
        physical re-layout now would be clobbered when that step writes
        its (old-layout) outputs back into the live pytree — diverging
        the logical and physical plans.  Physically-backed pipelined loops
        must call `maybe_swap()` themselves at a true step boundary
        (after the step's write-back, before the next dispatch); the sync
        `schedule()` path swaps automatically."""
        if self.param_swapper is None:
            self.maybe_swap()
        self.scheduler.submit(items)
        self._pending_items = list(items)

    def collect(self) -> Optional[ScheduleOutput]:
        out = self.scheduler.collect()
        if out is None:
            return None
        items, self._pending_items = self._pending_items or [], None
        self.trace.complete("schedule",
                            self.trace.now_us() - out.elapsed_s * 1e6,
                            out.elapsed_s * 1e6, cat="scheduler",
                            args={"batch": self.batch_idx,
                                  "n_items": len(items)})
        self.metrics.record_schedule(out)
        self.trace.counter("imbalance", out.imbalance)
        self.trace.counter("pred_cmax_s", out.cmax)
        ev = self.drift.observe_items(items, self.scheduler.tpm)
        if ev is not None:
            self._on_drift(ev)
        self.batch_idx += 1
        return out

    # ------------------------------------------------------------------ #
    def observe(self, module: str, shape: float, predicted: float,
                actual: float, plan=None) -> None:
        """Per-(module, shape) measured duration feedback.  Pass the
        producing `ScheduleOutput.plan` as `plan` so measurements taken
        under a pre-swap plan are keyed to the TP they actually ran at."""
        self.scheduler.observe(module, shape, predicted, actual, plan=plan)
        self.metrics.record_prediction(module, predicted, actual)
        if predicted > 0 and actual > 0:
            ev = self.drift.observe_residual(abs(actual / predicted - 1.0))
            if ev is not None:
                self._on_drift(ev)

    def observe_step(self, out: ScheduleOutput, measured_s: float, *,
                     idle_s: float = 0.0, busy_s: Optional[float] = None,
                     stage_busy=None) -> None:
        """Whole-step feedback: wall time vs. the predicted makespan.

        ``busy_s=None`` means "not measured" (the non-idle remainder of the
        step is assumed busy); an explicit ``0.0`` is a fully *idle* step
        and must yield bubble fraction 1.0, not 0.0."""
        self.trace.complete("step", self.trace.now_us() - measured_s * 1e6,
                            measured_s * 1e6, cat="step",
                            args={"pred_cmax_s": out.cmax})
        self.metrics.record_step(measured_s, idle_s, busy_s, stage_busy)
        self.trace.counter("bubble_fraction",
                           self.metrics.bubble_fraction.last())
        if out.cmax > 0 and measured_s > 0:
            ev = self.drift.observe_residual(abs(measured_s / out.cmax - 1.0))
            if ev is not None:
                self._on_drift(ev)

    # ------------------------------------------------------------------ #
    def _on_drift(self, event: DriftEvent) -> None:
        self.metrics.n_drift_events += 1
        self.trace.instant(f"drift:{event.kind}", cat="drift",
                           args={"statistic": event.statistic,
                                 "n_obs": event.n_obs})
        if not self.auto_replan:
            return
        with self._lock:
            if self._replan_future is not None:
                return                      # a search is already in flight
            dist = self.drift.window_distribution()
            if len(dist) == 0:
                dist = self.engine.dist
            # deterministic but distinct per firing: successive re-plans must
            # not resample the exact Monte-Carlo batches of the last one.
            self._replan_seed = self.batch_idx
            self._replan_future = self._pool.submit(self._search, dist, event)

    def _objective(self):
        """The engine's objective with the controller's re-plan trial
        budget.  An engine-pinned `Objective` instance keeps its
        configuration (quantile, solver, score) so re-plan decisions use
        the same risk level the initial plan was chosen under — only
        n_trials is overridden (get_objective copies, never mutates)."""
        return get_objective(self.engine.objective,
                             n_trials=self.replan_n_trials)

    def _search(self, dist: ShapeDistribution, event: DriftEvent):
        with self.trace.span("replan-search", cat="replan", tid=1,
                             kind=event.kind):
            # The calibrator couples the loop: the background search ranks
            # plans with the same refined durations the scheduler trusts.
            opt = ParallelismOptimizer(self.engine.cluster, self.engine.perf,
                                       mode=self.engine.mode,
                                       objective=self._objective(),
                                       calibrator=self.calibration,
                                       seed=self._replan_seed)
            res = opt.search(dist, self.gbs)
            # Score the incumbent here too: a sampling objective costs
            # real CPU, and maybe_swap() runs on the training-loop thread.
            # Only maybe_swap() mutates the plan and only one search is in
            # flight, so the plan captured here is the one compared at the
            # swap boundary.
            stale = self._plan_makespan(self.scheduler.plan, dist)
        return event, dist, res, stale

    def _plan_makespan(self, plan, dist: ShapeDistribution) -> float:
        """Evaluate a plan on `dist` under the engine's search objective —
        same objective, same calibrator, same Monte-Carlo seed — so
        stale-vs-new comparisons are like-for-like with `res.makespan`."""
        eng = self.engine
        return self._objective().evaluate(
            eng.perf, plan, dist, self.gbs, mode=eng.mode,
            corrector=self.calibration, seed=self._replan_seed)

    def maybe_swap(self) -> bool:
        """Adopt a finished background re-plan (batch-boundary only).

        With a `param_swapper`, adoption is *physical*: the live params
        are re-laid-out for the new plan before the logical swap (so the
        two never diverge — a failed reshard keeps the stale plan), and
        the decision is additionally gated on amortized cost: the
        predicted per-batch makespan advantage over
        ``swap_horizon_batches`` must exceed the measured/estimated
        reshard time (layout reconfiguration is not free)."""
        with self._lock:
            fut = self._replan_future
            if fut is None or not fut.done():
                return False
            self._replan_future = None
        try:
            event, dist, res, stale = fut.result()
        except Exception as e:  # noqa: BLE001 — a failed background search
            # must not take down the training loop; the detector stays armed
            # and the next drift event retries.
            self.trace.instant("replan-error", cat="replan",
                               args={"error": f"{type(e).__name__}: {e}"})
            return False
        # Guard the not-found path: res.makespan is meaningless without a
        # feasible plan — record inf, never compare against `stale`.
        new_mk = res.makespan if res.found else float("inf")
        swapped = res.found and new_mk < stale * (1.0 - self.min_improvement)
        gated: Optional[str] = None
        report = None
        old_plan = self.scheduler.plan
        roster = getattr(self.scheduler, "roster_chips", None)
        if swapped and roster is not None and res.plan.chips > roster:
            # the background search raced a roster shrink: its plan was
            # sized for the pre-failure fleet and cannot be fielded now
            swapped = False
            gated = "roster"
            self.trace.instant("swap-gated", cat="replan",
                               args={"reason": gated,
                                     "plan_chips": res.plan.chips,
                                     "roster_chips": roster})
        if swapped and self.param_swapper is not None:
            gated = self._physical_gate(old_plan, res.plan, stale, new_mk)
            if gated is None:
                # span recorded manually, on success only: a "reshard"
                # slice in the trace must mean a re-layout actually
                # happened (consumers count them as physical swaps)
                t_us = self.trace.now_us()
                try:
                    report = self.param_swapper.swap(old_plan, res.plan)
                    self.trace.complete(
                        "reshard", t_us, self.trace.now_us() - t_us,
                        cat="reshard",
                        args={"old": list(old_plan.as_tuple()),
                              "new": list(res.plan.as_tuple())})
                except Exception as e:  # noqa: BLE001 — same contract as a
                    # failed search: never take down the training loop...
                    self.trace.instant(
                        "reshard-error", cat="reshard",
                        args={"error": f"{type(e).__name__}: {e}"})
                    # ...unless a failed *donated* transfer already
                    # consumed the live buffers — the stale layout is gone
                    # too, so continuing would train on a deleted pytree.
                    # Fail fast instead of silently keeping a broken plan.
                    if getattr(self.param_swapper, "damaged", False):
                        raise
                    gated = "reshard-error"
            if gated is not None:
                swapped = False
                self.trace.instant("swap-gated", cat="replan",
                                   args={"reason": gated,
                                         "stale_makespan_s": stale,
                                         "new_makespan_s": new_mk})
            else:
                self.metrics.record_reshard(report.elapsed_s)
                self.trace.counter("reshard_s", report.elapsed_s)
        if swapped:
            self.scheduler.set_plan(res.plan)
            self.engine.plan_result = res
            self.metrics.n_replans += 1
            self.trace.instant("plan-swap", cat="replan",
                               args={"stale_makespan_s": stale,
                                     "new_makespan_s": new_mk,
                                     "plan": list(res.plan.as_tuple())})
            if self.composer is not None:
                # the window was priced under the old θ*; re-price before
                # the next composition targets the swapped plan
                self.composer.flush_plan()
                self.trace.instant("composer-flush", cat="compose",
                                   args={"pending": self.composer.pending})
        # Re-arm against the drifted regime either way, otherwise the same
        # shift keeps firing the detector every cooldown window.
        self.drift.rebase(dist)
        self.replans.append(ReplanRecord(
            event, stale, new_mk, swapped, res.elapsed_s,
            res.plan.as_tuple() if res.found else None,
            gated=gated, reshard=report))
        return swapped

    def _physical_gate(self, old_plan, new_plan, stale: float,
                       new_mk: float) -> Optional[str]:
        """Why a physically-backed swap must NOT happen (None = allowed).

        The amortization gate compares the predicted makespan advantage
        accumulated over the horizon against the swapper's cost estimate —
        measured reshard time once a swap has happened, a bytes/bandwidth
        model before that."""
        sw = self.param_swapper
        compat = getattr(sw, "compatible", None)
        if compat is not None and not compat(old_plan, new_plan):
            return "incompatible"
        est = getattr(sw, "estimate_cost_s", None)
        cost = float(est(old_plan, new_plan)) if est is not None else 0.0
        gain = (stale - new_mk) * self.swap_horizon_batches
        if gain <= cost:
            return "amortization"
        return None

    # ------------------------------------------------------------------ #
    def poll_fleet(self) -> List[RecoveryRecord]:
        """Drain fleet membership events and recover (batch boundary).

        Events queued since the last poll are coalesced into ONE recovery
        — a simultaneous fail+fail (or a fail raced by a join) re-plans
        once, for the roster that results.  No fleet or no events: no-op.
        Physically-backed pipelined loops must call this at a true step
        boundary, same contract as `maybe_swap()`."""
        if self.fleet is None:
            return []
        events = self.fleet.poll_events()
        if not events:
            return []
        for ev in events:
            self.metrics.record_membership(ev.kind)
            self.trace.instant(f"fleet:{ev.kind}", cat="fleet",
                               args={"host": ev.host_id, "step": ev.step,
                                     "n_alive_after": ev.n_alive_after})
        rec = self._recover_roster(tuple(events))
        self.recoveries.append(rec)
        self.metrics.record_recovery(rec.elapsed_s, degraded=rec.degraded)
        self.trace.counter("fleet_chips", rec.n_chips)
        return [rec]

    def _recover_roster(self, events: tuple) -> RecoveryRecord:
        """Checkpoint-free recovery onto the current roster.

        Fallback chain — degrade, never crash: (1) re-plan for the new
        roster's chip count and migrate the live params to the winner;
        (2) if the search fails, finds nothing, or its plan can't be
        fielded/reshard, *re-place* the old plan onto the survivors
        (`ParamSwapper.refresh` through the fleet mesh factory); (3) if
        even re-placement fails, continue on the stale layout.  The only
        raise is a swapper marked ``damaged`` — donated buffers are gone
        and there is nothing left to train on."""
        t0 = time.monotonic()
        old_plan = self.scheduler.plan
        n_chips = self.fleet.n_chips
        self.scheduler.set_roster(n_chips)
        error: Optional[str] = None
        res = None
        with self.trace.span("fleet-recovery", cat="fleet",
                             n_chips=n_chips, n_events=len(events)):
            dist = self.drift.window_distribution()
            if len(dist) == 0:
                dist = self.engine.dist
            try:
                opt = ParallelismOptimizer(
                    self.fleet.cluster_spec(self.engine.cluster),
                    self.engine.perf, mode=self.engine.mode,
                    objective=self._objective(),
                    calibrator=self.calibration, seed=self.batch_idx)
                res = opt.search(dist, self.gbs)
            except Exception as e:  # noqa: BLE001 — an infeasible search
                # degrades to the surviving roster, never crashes the loop
                error = f"{type(e).__name__}: {e}"
            candidate = (res.plan if res is not None and res.found
                         and res.plan.chips <= n_chips else None)
            if (candidate is not None
                    and candidate.as_tuple() == old_plan.as_tuple()):
                candidate = None      # same θ — a re-placement, not a swap
            target = candidate if candidate is not None else old_plan
            report = None
            if self.param_swapper is not None:
                attempts = ([old_plan] if target is old_plan
                            else [target, old_plan])
                for attempt in attempts:
                    t_us = self.trace.now_us()
                    try:
                        if attempt is old_plan:
                            report = self.param_swapper.refresh(old_plan)
                        else:
                            report = self.param_swapper.swap(old_plan,
                                                             attempt)
                        target = attempt
                        self.trace.complete(
                            "fleet-reshard", t_us,
                            self.trace.now_us() - t_us, cat="fleet",
                            args={"old": list(old_plan.as_tuple()),
                                  "new": list(attempt.as_tuple())})
                        self.metrics.record_reshard(report.elapsed_s)
                        break
                    except Exception as e:  # noqa: BLE001 — fall through
                        # the chain; stale layout is the last resort
                        self.trace.instant(
                            "fleet-reshard-error", cat="fleet",
                            args={"error": f"{type(e).__name__}: {e}"})
                        if getattr(self.param_swapper, "damaged", False):
                            raise
                        error = error or f"{type(e).__name__}: {e}"
                        target = old_plan
        adopted = target is not old_plan
        if adopted:
            self.scheduler.set_plan(target)
            self.engine.plan_result = res
            if self.composer is not None:
                self.composer.flush_plan()
        degraded = not adopted and (n_chips < old_plan.chips
                                    or error is not None)
        return RecoveryRecord(
            events=events, n_chips=n_chips,
            old_plan_tuple=old_plan.as_tuple(),
            new_plan_tuple=target.as_tuple() if adopted else None,
            adopted=adopted, degraded=degraded,
            elapsed_s=time.monotonic() - t0,
            reshard=report, error=error)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until any in-flight search finishes, then try to swap.
        Returns True if a swap happened (test/benchmark hook)."""
        with self._lock:
            fut = self._replan_future
        if fut is not None:
            concurrent.futures.wait([fut], timeout=timeout)
        return self.maybe_swap()

    @property
    def replan_in_flight(self) -> bool:
        with self._lock:
            return self._replan_future is not None

    # ------------------------------------------------------------------ #
    def export_trace(self, path: str) -> str:
        return self.trace.export(path)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        self.maybe_swap()

    def __enter__(self) -> "RuntimeController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
