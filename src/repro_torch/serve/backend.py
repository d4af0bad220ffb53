"""Execution backends behind the backend-agnostic serving loop.

The first `ServeEngine` fused *policy* (admission, SLO accounting, the
calibrator/drift/re-price feedback) with *execution* (how long a prefill
batch, KV handoff or decode step actually takes).  This module is the
seam between the two: `ServeEngine` owns the event loop and every policy
decision; an `ExecutionBackend` owns only the physics —

  * `EmulatedBackend` — that engine's discrete-event emulation, extracted
    verbatim: durations are perf-model base costs scaled by each
    request's oracle ``true_factor`` plus deterministic padding and
    compile-bucket penalties.  Bit-identical to the pre-refactor engine
    (pinned by the fig19 golden differential test).
  * `RealBackend` (`repro_torch.serve.real`) — prefill/decode steps on the
    model, run per pow2 shape bucket, with device-to-device KV cache-row
    transfer; durations are *measured*
    wall-clock seconds, which is what lets the calibrator/drift loop
    close against silicon instead of the oracle.

The outcome structs carry everything the loop needs to keep its virtual
clock and telemetry: total duration, per-request actual durations (the
calibrator observation stream), per-chunk durations (chunked prefill
interleaves with decode at chunk boundaries) and how many novel compile
buckets the call opened.

>>> PrefillOutcome(1.5, (1.0, 0.5), chunks=(1.5,)).duration_s
1.5
>>> DecodeOutcome(0.25).n_new_shapes
0
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.data.composer import _pow2
from repro_torch.models.layers.attention import kv_cache_bytes
from repro_torch.serve.request import Request


@dataclass(frozen=True)
class PrefillOutcome:
    """One executed prefill batch.

    ``per_request_actual`` aligns with the batch order and feeds the
    calibrator (`ServeEngine._observe`); ``chunks`` are per-chunk
    durations summing to ``duration_s`` — a single entry means the batch
    ran one-shot and the loop schedules it as the first engine did."""

    duration_s: float
    per_request_actual: Tuple[float, ...]
    chunks: Tuple[float, ...] = ()
    n_new_shapes: int = 0


@dataclass(frozen=True)
class DecodeOutcome:
    """One continuous-batch decode step across a worker's active rows."""

    duration_s: float
    n_new_shapes: int = 0


class ExecutionBackend:
    """What the serving loop delegates: execution physics, nothing else.

    The loop guarantees the call protocol: ``prefill`` for an admitted
    batch, then ``handoff`` per request, then ``join`` → repeated
    ``decode_step`` → ``release`` on a decode worker.  ``release`` with
    ``park=True`` is a preemption — the backend must preserve the
    request's generation state for a later re-``join``."""

    name = "abstract"
    #: True when decode durations are measurements worth feeding the
    #: calibrator ("decode" cells); the emulation's oracle durations are
    #: already the predictions, so observing them would be circular.
    observes_decode = False

    def prefill(self, worker: int, batch: Sequence[Request],
                s_pad: int) -> PrefillOutcome:
        raise NotImplementedError

    def handoff(self, req: Request) -> float:
        """Move one request's KV state prefill → decode; returns seconds."""
        raise NotImplementedError

    def handoff_s_mean(self) -> float:
        """Rough per-request handoff estimate for admission slack."""
        raise NotImplementedError

    def join(self, worker: int, req: Request) -> None:
        """Request takes a decode slot on ``worker`` (step boundary)."""

    def decode_step(self, worker: int, active: Sequence[Request]) -> DecodeOutcome:
        raise NotImplementedError

    def release(self, worker: int, req: Request, park: bool = False) -> None:
        """Request leaves its slot: finished (``park=False``) or preempted
        (``park=True`` — state must survive for a re-join)."""


class EmulatedBackend(ExecutionBackend):
    """The first engine's discrete-event execution model, verbatim.

    Durations are pure functions of the perf model, each request's oracle
    ``true_factor``, pow2 padding and first-touch compile buckets — the
    float operation *order* below is the pre-refactor engine's, which is
    what keeps fig19 rows byte-equal across the refactor."""

    name = "emulated"

    def __init__(self, pricer, cfg):
        self.pricer = pricer
        self.cfg = cfg
        self._seen_prefill_shapes: set = set()
        self._seen_decode_shapes: set = set()

    # ------------------------------------------------------------------ #
    def _kv_bytes(self, seq_len: int) -> float:
        return kv_cache_bytes(self.pricer.perf.llm.cfg, seq_len,
                              self.cfg.kv_bytes_per_value)

    def prefill(self, worker: int, batch: Sequence[Request],
                s_pad: int) -> PrefillOutcome:
        dur = 0.0
        actuals: List[float] = []
        for r in batch:
            base, _, _ = self.pricer.base(r)
            dur += base * r.true_factor + self.pricer.pad_extra(r, s_pad)
            actuals.append(base * r.true_factor)
        key = (_pow2(len(batch)), s_pad)
        n_new = 0
        if key not in self._seen_prefill_shapes:
            self._seen_prefill_shapes.add(key)
            dur += self.cfg.compile_s
            n_new = 1
        return PrefillOutcome(duration_s=dur, per_request_actual=tuple(actuals),
                              chunks=(dur,), n_new_shapes=n_new)

    def handoff(self, req: Request) -> float:
        _, _, s = self.pricer.base(req)
        return (self._kv_bytes(s) / (self.cfg.kv_bandwidth_gbps * 1e9)
                + self.cfg.kv_latency_s)

    def handoff_s_mean(self) -> float:
        return self._kv_bytes(1024) / (self.cfg.kv_bandwidth_gbps * 1e9) \
            + self.cfg.kv_latency_s

    def decode_step(self, worker: int, active: Sequence[Request]) -> DecodeOutcome:
        n = len(active)
        pad = _pow2(n) / n                 # pow2-bucketed batch occupancy
        dur = 0.0
        for r in active:
            _, _, s = self.pricer.base(r)
            c = s + r.tokens_done
            dur += self.pricer.decode_tok_s(c) * r.true_factor
        dur *= pad
        key = _pow2(n)
        n_new = 0
        if key not in self._seen_decode_shapes:
            self._seen_decode_shapes.add(key)
            dur += self.cfg.compile_s
            n_new = 1
        return DecodeOutcome(duration_s=dur, n_new_shapes=n_new)
