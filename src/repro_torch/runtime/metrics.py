"""Rolling runtime counters for the control loop.

Tracks, over a sliding window of recent global batches:
  * scheduler imbalance   — ``ScheduleOutput.cmax / lower_bound − 1``
  * bubble fraction       — pipeline idle / (idle + busy) per step
  * per-stage utilization — stage busy time / step makespan
  * prediction error      — |actual/predicted − 1| per module

These are the observability half of the profile → plan → schedule →
observe → re-plan loop: the controller reads them for re-plan decisions
and mirrors them into the trace as counter tracks.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Optional

import numpy as np


class RollingStat:
    """Bounded-window scalar stream with O(1) append.

    An *empty* window has no statistics: ``mean/max/quantile`` return NaN,
    never a fake 0.0 — a fully-overloaded serve run that completed nothing
    must report p99 latency as *missing*, not as a perfect 0 ms.  Renderers
    map NaN to absent (`nan_to_none`); ``last()`` likewise returns NaN so
    display paths can tell "no data yet" from a measured zero."""

    __slots__ = ("_buf", "count")

    def __init__(self, window: int = 256):
        self._buf: Deque[float] = deque(maxlen=window)
        self.count = 0                     # lifetime observations

    def add(self, x: float) -> None:
        self._buf.append(float(x))
        self.count += 1

    def mean(self) -> float:
        return float(np.mean(self._buf)) if self._buf else float("nan")

    def max(self) -> float:
        return float(np.max(self._buf)) if self._buf else float("nan")

    def last(self) -> float:
        return self._buf[-1] if self._buf else float("nan")

    def quantile(self, q: float) -> float:
        """Windowed quantile (serving p50/p99 tails).  O(window log window)
        — called at snapshot/report time, never on the hot path."""
        return float(np.quantile(self._buf, q)) if self._buf else float("nan")

    def __len__(self) -> int:
        return len(self._buf)


def nan_to_none(x: float):
    """NaN → None, so JSON-bound snapshots stay valid JSON (`json.dumps`
    would emit the non-standard literal ``NaN``) and missing stats render
    as absent rather than numeric."""
    return None if isinstance(x, float) and np.isnan(x) else x


class RuntimeMetrics:
    def __init__(self, window: int = 256):
        self.window = window
        self.imbalance = RollingStat(window)
        self.sched_elapsed_s = RollingStat(window)
        self.pred_cmax_s = RollingStat(window)
        self.bubble_fraction = RollingStat(window)
        self.step_time_s = RollingStat(window)
        self.reshard_s = RollingStat(window)
        self.compose_elapsed_s = RollingStat(window)
        self.compose_pred_gain = RollingStat(window)
        self.truncated_tokens = RollingStat(window)
        self.stage_util: Dict[int, RollingStat] = {}
        self.pred_error: Dict[str, RollingStat] = {}
        self.n_schedules = 0
        self.n_steps = 0
        self.n_replans = 0
        self.n_drift_events = 0
        self.n_physical_swaps = 0
        # -- fleet membership (repro_torch.launch.fleet) ---------------- #
        self.n_host_joins = 0
        self.n_host_leaves = 0          # graceful leaves + failures
        self.n_host_failures = 0
        self.n_recoveries = 0           # checkpoint-free roster recoveries
        self.n_degraded = 0             # recoveries that fell back to the
        #                                 stale/re-placed plan (no better
        #                                 plan adoptable on the survivors)
        self.recovery_s = RollingStat(window)
        self.n_composed = 0
        self.n_forced_items = 0
        self.n_truncated_tokens = 0
        # -- MoE dispatch (models/layers/moe.py capacity paths) --------- #
        # NaN observations (no MoE layers / unmeasured shard_map dispatch)
        # are skipped at record time; an all-NaN run leaves the windows
        # empty, so the snapshot reports None rather than a fake 0.0.
        self.moe_drop_rate = RollingStat(window)
        self.moe_imbalance = RollingStat(window)
        # -- serving (repro.serve.engine) ------------------------------- #
        # latency/ttft keep a wider window: p99 over 256 samples is noise
        self.queue_depth = RollingStat(window)
        self.batch_occupancy = RollingStat(window)   # decode rows / slots
        self.prefill_batch_s = RollingStat(window)
        self.decode_step_s = RollingStat(window)
        self.latency_s = RollingStat(max(window, 2048))
        self.ttft_s = RollingStat(max(window, 2048))
        self.n_requests = 0
        self.n_admitted = 0
        self.n_prefill_batches = 0
        self.n_decode_steps = 0
        self.n_handoffs = 0
        self.n_completed = 0
        self.n_slo_met = 0
        self.n_serve_compiles = 0
        self.n_preemptions = 0          # decode-slot evictions (SLO rescue)
        self.n_prefill_chunks = 0       # chunk events from chunked prefill

    # ------------------------------------------------------------------ #
    def record_schedule(self, out) -> None:
        """`out`: a ScheduleOutput (duck-typed to avoid a core import)."""
        self.imbalance.add(out.imbalance)
        self.sched_elapsed_s.add(out.elapsed_s)
        self.pred_cmax_s.add(out.cmax)
        self.n_schedules += 1

    def record_step(self, step_time_s: float, idle_s: float,
                    busy_s: Optional[float] = None,
                    stage_busy: Optional[np.ndarray] = None) -> None:
        """``busy_s=None`` (not measured) defaults to the non-idle
        remainder of the step; an explicit ``0.0`` means a fully idle step
        (bubble fraction 1.0) — the two must not be conflated."""
        if busy_s is None:
            busy_s = max(step_time_s - idle_s, 0.0)
        self.step_time_s.add(step_time_s)
        self.bubble_fraction.add(idle_s / max(idle_s + busy_s, 1e-12))
        if stage_busy is not None and step_time_s > 0:
            for p, b in enumerate(np.asarray(stage_busy, dtype=float)):
                self.stage_util.setdefault(
                    p, RollingStat(self.window)).add(b / step_time_s)
        self.n_steps += 1

    def record_reshard(self, elapsed_s: float) -> None:
        """One physical param re-layout (plan hot-swap's device half)."""
        self.reshard_s.add(elapsed_s)
        self.n_physical_swaps += 1

    def record_membership(self, kind: str) -> None:
        """One fleet roster transition ("join" | "leave" | "fail")."""
        if kind == "join":
            self.n_host_joins += 1
        elif kind == "leave":
            self.n_host_leaves += 1
        elif kind == "fail":
            self.n_host_leaves += 1
            self.n_host_failures += 1
        else:
            raise ValueError(f"unknown membership kind {kind!r}")

    def record_recovery(self, elapsed_s: float, *,
                        degraded: bool = False) -> None:
        """One checkpoint-free roster recovery (re-plan + reshard onto the
        new roster).  ``degraded``: the controller fell back to the stale
        or re-placed plan instead of adopting a fresh search result."""
        self.recovery_s.add(elapsed_s)
        self.n_recoveries += 1
        self.n_degraded += bool(degraded)

    def record_compose(self, stats) -> None:
        """`stats`: a `repro.data.composer.ComposeStats` (duck-typed to
        avoid a core import)."""
        self.compose_elapsed_s.add(stats.elapsed_s)
        self.compose_pred_gain.add(stats.pred_gain)
        self.n_composed += 1
        self.n_forced_items += stats.n_forced

    def record_moe(self, drop_rate: float, imbalance: float) -> None:
        """Per-step MoE dispatch stats from the train step's aux
        (``moe_drop_rate`` / ``moe_imbalance``): the fraction of routed
        (token, expert) assignments dropped by the capacity clip, and the
        expert-load skew ``E·max(f) − 1``.  NaN means "not measured"
        (no MoE layers, or shard_map dispatch) and is not recorded —
        the window must never mistake missing data for perfect balance."""
        if not np.isnan(drop_rate):
            self.moe_drop_rate.add(drop_rate)
        if not np.isnan(imbalance):
            self.moe_imbalance.add(imbalance)

    def record_pack(self, truncated: int) -> None:
        """Per-global-batch truncated-token count from the packing path —
        silent truncation is a correctness smell, so it is first-class in
        the step telemetry."""
        self.truncated_tokens.add(truncated)
        self.n_truncated_tokens += int(truncated)

    # ------------------------------------------------------------------ #
    # Serving-side counters (`repro.serve.engine` is the only writer).
    def record_admission(self, queue_depth: int, batch_size: int,
                         duration_s: float) -> None:
        """One prefill batch admitted (duration_s: emulated batch time)."""
        self.queue_depth.add(queue_depth)
        self.prefill_batch_s.add(duration_s)
        self.n_admitted += batch_size
        self.n_prefill_batches += 1

    def record_decode_step(self, occupancy: float, duration_s: float) -> None:
        """One continuous-batch decode step (occupancy: rows / slots)."""
        self.batch_occupancy.add(occupancy)
        self.decode_step_s.add(duration_s)
        self.n_decode_steps += 1

    def record_completion(self, latency_s: float, ttft_s: float,
                          slo_met: bool) -> None:
        self.latency_s.add(latency_s)
        if ttft_s >= 0:
            self.ttft_s.add(ttft_s)
        self.n_completed += 1
        self.n_slo_met += bool(slo_met)

    def record_prediction(self, module: str, predicted: float,
                          actual: float) -> None:
        if predicted <= 0 or actual <= 0:
            return
        self.pred_error.setdefault(
            module, RollingStat(self.window)).add(abs(actual / predicted - 1.0))

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """JSON-safe counter snapshot.  Stats whose window is empty appear
        as None ("no data"), never as a fake 0.0."""
        _n = nan_to_none
        return {
            "n_schedules": self.n_schedules,
            "n_steps": self.n_steps,
            "n_replans": self.n_replans,
            "n_drift_events": self.n_drift_events,
            "n_physical_swaps": self.n_physical_swaps,
            "n_composed": self.n_composed,
            "n_forced_items": self.n_forced_items,
            "n_truncated_tokens": self.n_truncated_tokens,
            "compose_elapsed_mean_s": _n(self.compose_elapsed_s.mean()),
            "compose_pred_gain_mean": _n(self.compose_pred_gain.mean()),
            "truncated_tokens_mean": _n(self.truncated_tokens.mean()),
            "reshard_mean_s": _n(self.reshard_s.mean()),
            "moe_drop_rate_mean": _n(self.moe_drop_rate.mean()),
            "moe_drop_rate_last": _n(self.moe_drop_rate.last()),
            "moe_imbalance_mean": _n(self.moe_imbalance.mean()),
            "moe_imbalance_max": _n(self.moe_imbalance.max()),
            "imbalance_mean": _n(self.imbalance.mean()),
            "imbalance_last": _n(self.imbalance.last()),
            "sched_elapsed_mean_s": _n(self.sched_elapsed_s.mean()),
            "pred_cmax_mean_s": _n(self.pred_cmax_s.mean()),
            "bubble_fraction_mean": _n(self.bubble_fraction.mean()),
            "step_time_mean_s": _n(self.step_time_s.mean()),
            "stage_utilization": {p: _n(s.mean())
                                  for p, s in sorted(self.stage_util.items())},
            "pred_error": {m: _n(s.mean())
                           for m, s in sorted(self.pred_error.items())},
            "fleet": {
                "n_host_joins": self.n_host_joins,
                "n_host_leaves": self.n_host_leaves,
                "n_host_failures": self.n_host_failures,
                "n_recoveries": self.n_recoveries,
                "n_degraded": self.n_degraded,
                "recovery_mean_s": _n(self.recovery_s.mean()),
            },
            "serve": {
                "n_requests": self.n_requests,
                "n_admitted": self.n_admitted,
                "n_prefill_batches": self.n_prefill_batches,
                "n_decode_steps": self.n_decode_steps,
                "n_handoffs": self.n_handoffs,
                "n_completed": self.n_completed,
                "n_slo_met": self.n_slo_met,
                "n_serve_compiles": self.n_serve_compiles,
                "n_preemptions": self.n_preemptions,
                "n_prefill_chunks": self.n_prefill_chunks,
                "queue_depth_mean": _n(self.queue_depth.mean()),
                "batch_occupancy_mean": _n(self.batch_occupancy.mean()),
                "prefill_batch_mean_s": _n(self.prefill_batch_s.mean()),
                "decode_step_mean_s": _n(self.decode_step_s.mean()),
                "latency_p50_s": _n(self.latency_s.quantile(0.50)),
                "latency_p99_s": _n(self.latency_s.quantile(0.99)),
                "ttft_p50_s": _n(self.ttft_s.quantile(0.50)),
            },
        }
