"""Data-aware serving loop: admission → prefill pool → KV handoff →
continuous-batch decode pool, backend-agnostic.

DFLOP's training loop (profile → plan → schedule → observe → re-plan)
maps onto inference as:

  * **profile**  — the same `PerfModel` prices per-request prefill cost
    (`PrefillPricer`, via ``e_dur``/``l_dur``) and per-token decode cost
    (decode-mode FLOPs, affine in the context length);
  * **schedule** — the admission policy forms prefill batches
    (`SLOAdmission`: EDF deadline reservation + homogeneous-run scoring;
    `FIFOAdmission`: arrival order);
  * **observe**  — every executed prefill batch feeds the
    `OnlineCalibrator` with (predicted base, actual) and the residual
    stream into a `PageHinkley` drift test;
  * **re-plan**  — a drift event flushes the pricer's memoized admission
    prices (prefill *and* decode fits) so they are re-estimated under
    the post-drift calibration.

The loop owns virtual time, SLO accounting and every policy decision;
*execution physics* live behind a pluggable `ExecutionBackend`
(`repro_torch.serve.backend`): `EmulatedBackend` replays the first engine's discrete-event
model bit-identically (oracle ``true_factor`` durations, numpy + heapq,
no wall clock), while `RealBackend` (`repro_torch.serve.real`) runs
prefill/decode steps on the model and feeds *measured*
wall-clock durations through the same calibrator/drift/re-price path.
Real execution is eager — the backend runs each batch when the loop
admits it and the measured duration is replayed on the virtual clock —
so both backends share one event loop and one telemetry surface.

Disaggregation follows DistTrain's phase split: prefill and decode run on
*separate* worker pools with an explicit KV-handoff step (priced as
bytes/bandwidth + latency when emulated; an actual device-to-device
cache transfer when real).  Decode is continuously batched — requests
join and leave a worker's batch only at step boundaries, and the batch is
padded to a power-of-two occupancy so the jit cache sees a bounded set of
shapes (each novel (pool, bucket) pays a compile).

Two loop-level policies only make sense against a backend boundary:

  * **chunked prefill** — a backend may split a batch into chunks
    (`PrefillOutcome.chunks`); the loop schedules each chunk as its own
    event, so decode steps interleave with a long prompt's prefill
    instead of stalling behind it;
  * **decode-slot preemption** (``preempt_slack_s``) — at a step
    boundary, if a ready request's SLO slack is below the threshold and
    the worker is full, the active request with the most slack is parked
    (``release(park=True)``; the backend preserves its generation state)
    and the urgent request takes the slot.

>>> ServeConfig(decode_slots=8).decode_slots
8
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.composer import _pow2
from repro_torch.serve.admission import FIFOAdmission, PrefillPricer, SLOAdmission
from repro_torch.serve.backend import (EmulatedBackend, ExecutionBackend,
                                 PrefillOutcome)
from repro_torch.serve.request import (DECODING, DONE, HANDOFF, PREFILLING,
                                 Request, RequestQueue)


@dataclass(frozen=True)
class ServeConfig:
    """Serving cluster + engine knobs (shared by both backends)."""

    n_prefill_workers: int = 2
    n_decode_workers: int = 2
    decode_slots: int = 8            # continuous-batch rows per decode worker
    max_prefill_batch: int = 8
    tp: int = 1                      # per-worker tensor parallelism
    compile_s: float = 0.25          # opening a novel (pool, shape) bucket
    kv_bandwidth_gbps: float = 64.0  # prefill → decode interconnect
    kv_latency_s: float = 0.002
    kv_bytes_per_value: int = 2      # bf16 KV cache
    # decode-slot preemption for SLO rescue: a ready request whose slack
    # drops below this threshold may evict the slack-richest active row
    # at a step boundary.  None disables (the first engine's behavior).
    preempt_slack_s: Optional[float] = None


@dataclass
class ServeReport:
    """Headline numbers of one `ServeEngine.run` (fig19 rows come from
    this; percentiles over *all* completions, not the metrics window)."""

    policy: str
    n_requests: int
    n_completed: int
    n_slo_met: int
    makespan_s: float
    goodput_rps: float               # SLO-met completions per second
    throughput_rps: float
    p50_latency_s: float
    p99_latency_s: float
    mean_ttft_s: float
    mean_queue_depth: float
    mean_occupancy: float
    n_prefill_batches: int
    n_decode_steps: int
    n_drift_events: int
    n_compiles: int

    def row(self) -> dict:
        """JSON-safe dict: missing stats (NaN — e.g. p99 latency with zero
        completions) become None/absent, never a fake 0.0."""
        from repro_torch.runtime.metrics import nan_to_none
        return {k: nan_to_none(v) for k, v in self.__dict__.items()}


class _DecodeWorker:
    __slots__ = ("idx", "active", "busy")

    def __init__(self, idx: int):
        self.idx = idx
        self.active: List[Request] = []
        self.busy = False                  # a decode_step event is in flight


class ServeEngine:
    """Event-driven admission/batching loop over a live request stream."""

    def __init__(self, pricer: PrefillPricer, cfg: ServeConfig = ServeConfig(),
                 *, backend: Optional[ExecutionBackend] = None,
                 admission=None, calibrator=None, drift=None,
                 trace=None, metrics=None):
        """``backend``: the `ExecutionBackend` executing (or emulating)
        prefill/handoff/decode; default `EmulatedBackend` over ``pricer``.
        ``admission``: policy with ``select(pending, now_s, max_batch)``
        and ``note_batch(duration_s)`` (default: `SLOAdmission` around
        ``pricer``).  ``calibrator``/``drift``/``trace``/``metrics`` are
        the runtime-layer hooks (`OnlineCalibrator`, `PageHinkley`,
        `TraceRecorder`, `RuntimeMetrics`); any may be None."""
        self.pricer = pricer
        self.cfg = cfg
        self.backend = backend if backend is not None \
            else EmulatedBackend(pricer, cfg)
        self.admission = admission if admission is not None \
            else SLOAdmission(pricer, handoff_s=self.backend.handoff_s_mean())
        self.calibrator = calibrator
        self.drift = drift
        self.trace = trace
        self.metrics = metrics
        self.queue = RequestQueue()
        self.n_drift_events = 0
        self.n_compiles = 0
        self.n_preemptions = 0
        #: (module, corrected prediction, actual) per observation — the
        #: whole run, unlike the metrics' rolling window (fig22 compares
        #: early- vs late-run error to show calibration converging).
        self.prediction_log: List[Tuple[str, float, float]] = []
        self._prefill_busy = [False] * cfg.n_prefill_workers
        self._decode = [_DecodeWorker(i) for i in range(cfg.n_decode_workers)]
        self._ready: List[Request] = []    # handoff done, awaiting a slot
        self._completed: List[Request] = []
        self._heap: List[tuple] = []
        self._seq = 0                      # heap tie-break, keeps FIFO order

    # ------------------------------------------------------------------ #
    def _handoff_s(self, req: Request) -> float:
        return self.backend.handoff(req)

    def _push(self, t: float, kind: str, payload=None) -> None:
        heapq.heappush(self._heap, (t, self._seq, kind, payload))
        self._seq += 1

    def _note_compiles(self, n_new: int) -> None:
        if n_new:
            self.n_compiles += n_new
            if self.metrics is not None:
                self.metrics.n_serve_compiles += n_new

    # ------------------------------------------------------------------ #
    def run(self, requests: Sequence[Request]) -> ServeReport:
        """Serve a finite open-loop stream to completion."""
        if self.metrics is not None:
            self.metrics.n_requests += len(requests)
        for r in sorted(requests, key=lambda r: r.arrival_s):
            self._push(r.arrival_s, "arrival", r)
        while self._heap:
            t, _, kind, payload = heapq.heappop(self._heap)
            if kind == "arrival":
                self.queue.push(payload)
                self._try_admit(t)
            elif kind == "prefill_chunk":
                self._on_prefill_chunk(t, *payload)
            elif kind == "prefill_done":
                self._on_prefill_done(t, *payload)
            elif kind == "handoff_done":
                self._on_handoff_done(t, payload)
            elif kind == "decode_step":
                self._decode_step(t, payload)
        return self._report(requests)

    # ------------------------------------------------------------------ #
    # Prefill pool
    def _try_admit(self, t: float) -> None:
        for w in range(self.cfg.n_prefill_workers):
            if self._prefill_busy[w]:
                continue
            batch = self.admission.select(self.queue.pending, t,
                                          self.cfg.max_prefill_batch)
            if not batch:
                return
            depth = self.queue.depth
            self.queue.pop(batch)
            s_pad = _pow2(max(self.pricer.base(r)[2] for r in batch))
            for r in batch:
                r.status = PREFILLING
                r.admit_s = t
            out = self.backend.prefill(w, batch, s_pad)
            dur = out.duration_s
            self._note_compiles(out.n_new_shapes)
            self._prefill_busy[w] = True
            self.admission.note_batch(dur)
            if self.metrics is not None:
                self.metrics.record_admission(depth, len(batch), dur)
            if self.trace is not None:
                self.trace.complete("prefill", t * 1e6, dur * 1e6,
                                    cat="serve", tid=100 + w,
                                    args={"batch": len(batch),
                                          "s_pad": s_pad, "queue": depth})
                self.trace.counter("serve_queue_depth", depth - len(batch))
            if len(out.chunks) > 1:
                # chunked prefill: each chunk is its own event, so decode
                # steps interleave with a long prompt on the virtual clock
                self._push(t + out.chunks[0], "prefill_chunk",
                           (w, batch, out, 0))
            else:
                self._push(t + dur, "prefill_done", (w, batch, out))

    def _on_prefill_chunk(self, t: float, w: int, batch: List[Request],
                          out: PrefillOutcome, i: int) -> None:
        if self.metrics is not None:
            self.metrics.n_prefill_chunks += 1
        if self.trace is not None:
            self.trace.complete("prefill_chunk", (t - out.chunks[i]) * 1e6,
                                out.chunks[i] * 1e6, cat="serve",
                                tid=100 + w, args={"chunk": i,
                                                   "of": len(out.chunks)})
        if i + 1 < len(out.chunks):
            self._push(t + out.chunks[i + 1], "prefill_chunk",
                       (w, batch, out, i + 1))
        else:
            self._on_prefill_done(t, w, batch, out)

    def _on_prefill_done(self, t: float, w: int, batch: List[Request],
                         out: PrefillOutcome) -> None:
        self._prefill_busy[w] = False
        for r, actual in zip(batch, out.per_request_actual):
            r.status = HANDOFF
            r.prefill_done_s = t
            self._observe(r, actual)
            if self.metrics is not None:
                self.metrics.n_handoffs += 1
            self._push(t + self.backend.handoff(r), "handoff_done", r)
        self._try_admit(t)

    def _observe(self, r: Request, actual: float) -> None:
        """observe → (maybe) re-estimate: calibration learns the residual
        heterogeneity the perf model can't see; Page–Hinkley watches the
        post-calibration residual stream and a fire flushes the memoized
        admission prices (re-priced under the new calibration).
        ``actual`` comes from the backend: oracle-scaled base (emulated)
        or a measured wall-clock share (real)."""
        base, _, s = self.pricer.base(r)
        if self.calibrator is not None:
            corrected = self.calibrator.correct("prefill", s,
                                                self.pricer.tp, base)
            self.calibrator.observe("prefill", s, self.pricer.tp, base,
                                    actual)
        else:
            corrected = base
        self.prediction_log.append(("prefill", corrected, actual))
        if self.metrics is not None:
            self.metrics.record_prediction("prefill", corrected, actual)
        if self.drift is not None:
            if self.drift.update(abs(actual / corrected - 1.0)):
                self.n_drift_events += 1
                self.pricer.flush()
                self.drift.reset()
                if self.metrics is not None:
                    self.metrics.n_drift_events += 1
                if self.trace is not None:
                    self.trace.instant("serve_drift_reprice", cat="serve")

    # ------------------------------------------------------------------ #
    # Decode pool (continuous batching)
    def _on_handoff_done(self, t: float, r: Request) -> None:
        r.status = DECODING
        r.handoff_done_s = t
        self._ready.append(r)
        # wake every idle worker: each pulls its share of the ready list at
        # its (immediate) step boundary; surplus wakes are no-ops
        for dw in self._decode:
            if not dw.busy:
                dw.busy = True
                self._push(t, "decode_step", dw.idx)

    def _decode_slack_s(self, r: Request, t: float) -> float:
        """SLO slack if the request decoded its remaining budget now."""
        _, _, s = self.pricer.base(r)
        rem = (r.max_new_tokens - r.tokens_done) \
            * self.pricer.decode_tok_s(s + r.tokens_done)
        return r.deadline_s - t - rem

    def _maybe_preempt(self, t: float, dw: _DecodeWorker) -> None:
        """SLO rescue at a step boundary: park the slack-richest active
        row for a ready request about to miss its deadline.  The backend
        preserves the victim's generation state (``park=True``); it
        re-joins through the normal ready queue."""
        if (self.cfg.preempt_slack_s is None or not self._ready
                or len(dw.active) < self.cfg.decode_slots):
            return
        urgent = min(self._ready, key=lambda r: self._decode_slack_s(r, t))
        u_slack = self._decode_slack_s(urgent, t)
        if u_slack > self.cfg.preempt_slack_s:
            return
        victim = max(dw.active, key=lambda r: self._decode_slack_s(r, t))
        # only evict a row that is comfortably safer than the threshold —
        # equal-slack swaps would ping-pong without rescuing anyone
        if self._decode_slack_s(victim, t) <= max(u_slack,
                                                  self.cfg.preempt_slack_s):
            return
        dw.active.remove(victim)
        self.backend.release(dw.idx, victim, park=True)
        victim.n_preempted += 1
        self._ready.append(victim)
        self._ready.remove(urgent)
        self._ready.insert(0, urgent)      # urgent takes the freed slot
        self.n_preemptions += 1
        if self.metrics is not None:
            self.metrics.n_preemptions += 1
        if self.trace is not None:
            self.trace.instant("decode_preempt", cat="serve",
                               args={"worker": dw.idx})

    def _decode_step(self, t: float, idx: int) -> None:
        dw = self._decode[idx]
        # join/leave ONLY here — a step boundary of this worker
        self._maybe_preempt(t, dw)
        while self._ready and len(dw.active) < self.cfg.decode_slots:
            r = self._ready.pop(0)
            r.decode_worker = idx
            dw.active.append(r)
            self.backend.join(idx, r)
        if not dw.active:
            dw.busy = False
            return
        out = self.backend.decode_step(idx, dw.active)
        dur = out.duration_s
        self._note_compiles(out.n_new_shapes)
        n = len(dw.active)
        self._observe_decode(dw, dur)
        end = t + dur
        finished = []
        for r in dw.active:
            r.tokens_done += 1
            if r.first_token_s < 0:
                r.first_token_s = end
            if r.tokens_done >= r.max_new_tokens:
                r.status = DONE
                r.finish_s = end
                finished.append(r)
        if finished:
            dw.active = [r for r in dw.active if r.status != DONE]
            for r in finished:
                self.backend.release(idx, r)
                self._completed.append(r)
                if self.metrics is not None:
                    self.metrics.record_completion(r.latency_s, r.ttft_s,
                                                   r.slo_met)
        if self.metrics is not None:
            self.metrics.record_decode_step(n / self.cfg.decode_slots, dur)
        if self.trace is not None:
            self.trace.complete("decode_step", t * 1e6, dur * 1e6,
                                cat="serve", tid=200 + idx,
                                args={"rows": n, "finished": len(finished)})
            self.trace.counter("serve_occupancy",
                               n / self.cfg.decode_slots)
        self._push(end, "decode_step", idx)

    def _observe_decode(self, dw: _DecodeWorker, dur: float) -> None:
        """Feed a *measured* decode-step duration into the calibrator's
        "decode" cells (apportioned over rows by their raw predicted
        share).  Only backends that measure (``observes_decode``) feed
        this — observing the emulation's own oracle would be circular."""
        if not self.backend.observes_decode or dur <= 0:
            return
        rows = []
        corrected = 0.0
        raw_tot = 0.0
        for r in dw.active:
            _, _, s = self.pricer.base(r)
            c = s + r.tokens_done
            shape = float(_pow2(int(c)))
            raw = self.pricer.decode_tok_base_s(c)
            if self.calibrator is not None:
                corrected += self.calibrator.correct("decode", shape,
                                                     self.pricer.tp, raw)
            else:
                corrected += raw
            rows.append((shape, raw))
            raw_tot += raw
        if self.calibrator is not None and raw_tot > 0:
            for shape, raw in rows:
                self.calibrator.observe("decode", shape, self.pricer.tp,
                                        raw, dur * raw / raw_tot)
        self.prediction_log.append(("decode", corrected, dur))
        if self.metrics is not None:
            self.metrics.record_prediction("decode", corrected, dur)

    # ------------------------------------------------------------------ #
    def _report(self, requests: Sequence[Request]) -> ServeReport:
        done = self._completed
        # no completions → latency stats are *missing* (NaN), not 0.0: a
        # fully-overloaded run must not report a perfect p99 (row() maps
        # NaN to None so JSON consumers see them as absent).
        nan = float("nan")
        lat = np.array([r.latency_s for r in done]) if done else None
        ttft = np.array([r.ttft_s for r in done if r.ttft_s >= 0])
        makespan = max((r.finish_s for r in done), default=0.0)
        n_slo = sum(r.slo_met for r in done)
        m = self.metrics
        return ServeReport(
            policy=getattr(self.admission, "name", "custom"),
            n_requests=len(requests),
            n_completed=len(done),
            n_slo_met=n_slo,
            makespan_s=makespan,
            goodput_rps=n_slo / max(makespan, 1e-12),
            throughput_rps=len(done) / max(makespan, 1e-12),
            p50_latency_s=float(np.quantile(lat, 0.5)) if lat is not None else nan,
            p99_latency_s=float(np.quantile(lat, 0.99)) if lat is not None else nan,
            mean_ttft_s=float(ttft.mean()) if len(ttft) else nan,
            mean_queue_depth=m.queue_depth.mean() if m else nan,
            mean_occupancy=m.batch_occupancy.mean() if m else nan,
            n_prefill_batches=m.n_prefill_batches if m else 0,
            n_decode_steps=m.n_decode_steps if m else 0,
            n_drift_events=self.n_drift_events,
            n_compiles=self.n_compiles,
        )
