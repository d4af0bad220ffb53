"""Serving request lifecycle and admission queue.

A request is a `DataItem` (the same two shape dimensions DFLOP's training
models are keyed on — encoder media items and LLM sequence length) plus
serving state: arrival time, a latency SLO, a decode budget, and the
timestamps the engine stamps as the request moves through

    QUEUED -> PREFILLING -> HANDOFF -> DECODING -> DONE

All times are *virtual* seconds on the emulated cluster clock (the engine
is a discrete-event emulation, cf. `repro_torch.core.pipeline.simulator`); the
trace recorder renders them as microseconds.

>>> from repro_torch.data.items import DataItem
>>> r = Request(item=DataItem(1, 128, "single_image", 0), arrival_s=0.0,
...             slo_s=2.0, max_new_tokens=4)
>>> q = RequestQueue()
>>> q.push(r); q.depth
1
>>> q.pop([r]); q.depth
0
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.data.items import DataItem

QUEUED = "queued"
PREFILLING = "prefilling"
HANDOFF = "handoff"
DECODING = "decoding"
DONE = "done"


@dataclass
class Request:
    """One inference request on the emulated cluster.

    ``true_factor`` is the oracle's per-request heterogeneity multiplier
    (modality bias x sampled noise): *actual* durations are predicted base
    durations scaled by it.  The load generator draws it per request id so
    two policies replayed on the same stream face bit-identical ground
    truth; the engine never reads it for admission decisions — only the
    calibrator may learn its per-shape-bucket mean from observations.
    """

    item: DataItem
    arrival_s: float
    slo_s: float                      # end-to-end deadline over arrival
    max_new_tokens: int
    true_factor: float = 1.0

    status: str = QUEUED
    admit_s: float = -1.0             # admission into a prefill batch
    prefill_done_s: float = -1.0
    handoff_done_s: float = -1.0
    first_token_s: float = -1.0
    finish_s: float = -1.0
    tokens_done: int = 0
    decode_worker: int = -1
    n_preempted: int = 0              # decode-slot evictions (SLO rescue)
    #: generated token ids — filled by real backends only (the emulation
    #: never materializes tokens); used to pin continuous-batch decode
    #: token-identical to a solo run of the same prompt
    generated: List[int] = field(default_factory=list)

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.slo_s

    @property
    def latency_s(self) -> float:
        """End-to-end latency (finish − arrival); −1 while in flight."""
        return self.finish_s - self.arrival_s if self.finish_s >= 0 else -1.0

    @property
    def ttft_s(self) -> float:
        """Time to first decoded token; −1 while pre-decode."""
        return (self.first_token_s - self.arrival_s
                if self.first_token_s >= 0 else -1.0)

    @property
    def slo_met(self) -> bool:
        return 0 <= self.latency_s <= self.slo_s

    def slack_s(self, now_s: float, remaining_work_s: float = 0.0) -> float:
        """Seconds of schedule slack left before the deadline becomes
        infeasible, after accounting for the work the request still needs
        (predicted prefill + handoff + decode).  Negative = already late."""
        return self.deadline_s - now_s - remaining_work_s


class RequestQueue:
    """Arrival-ordered admission queue.

    Arrival order is the only structure the queue itself imposes — FIFO
    admission takes a prefix, data-aware admission reorders a *view* of
    the pending list (never the queue), so the no-starvation property is
    enforced by the admission policy's EDF reservation, not by the
    container (see `repro_torch.serve.admission`).
    """

    def __init__(self):
        self._pending: List[Request] = []
        self.n_arrived = 0

    # ------------------------------------------------------------------ #
    @property
    def depth(self) -> int:
        return len(self._pending)

    @property
    def pending(self) -> List[Request]:
        """Live view, arrival-ordered; callers must not mutate."""
        return self._pending

    def push(self, req: Request) -> None:
        req.status = QUEUED
        self._pending.append(req)
        self.n_arrived += 1

    def pop(self, batch: Sequence[Request]) -> None:
        """Remove an admitted batch (set semantics: order-independent)."""
        chosen = set(id(r) for r in batch)
        self._pending = [r for r in self._pending if id(r) not in chosen]

    def oldest_wait_s(self, now_s: float) -> float:
        return now_s - self._pending[0].arrival_s if self._pending else 0.0
