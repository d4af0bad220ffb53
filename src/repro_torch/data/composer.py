"""Lookahead data-aware batch composition (extension of §3.4).

The Online Microbatch Scheduler balances items *within* a global batch the
loader already drew — but the draw itself is FIFO and data-blind.  On a
bursty stream (e.g. a run of video-heavy items inside a single-image
corpus) every FIFO batch mixes a few fat items into many thin ones, and
the fat item pins the bottleneck bucket no matter how well the scheduler
partitions: ``C_max >= max_i d_i`` is a *composition* property, not a
scheduling one.  `LookaheadComposer` attacks that remaining headroom by
maintaining a bounded reorder window of ``window · gbs`` items over the
stream and assembling each global batch from it.

Scoring uses the exact duration path the scheduler and optimizer already
share (`objective.corrected_item_durations` via
``scheduler.item_durations``), an LPT partition (`lpt_assign_batch`) and
the event-driven 1F1B simulator (`simulate_bucket_ranks_batch`) — all
candidates for one batch are scored in a single vectorized wavefront
call.  The greedy criterion is the *work-normalized* predicted step
makespan (makespan per second of compute the batch retires): minimizing
the raw makespan is myopic — it perpetually defers fat items, which then
force mixed batches when staleness binds — whereas time-per-work is the
greedy rule whose per-batch optimum minimizes the epoch sum ``Σ_t
makespan_t`` for a fixed total work.  Raw-makespan scoring remains
available as ``score="makespan"``.

Hard guarantees, property-pinned in ``tests/test_loader.py``:

  * **exactly-once** — every pushed item appears in exactly one composed
    batch; ``drain()`` empties the window at end of stream, so a finite
    epoch is an exact permutation of the FIFO epoch;
  * **bounded staleness** — an item waits at most ``max_staleness``
    ``compose()`` calls in the window.  Forcing only items *at* the
    bound is not enough (the initial window fill ages in lockstep, so
    more than gbs items can hit the bound in the same batch): each
    compose instead reserves EDF-style — it force-includes the
    ``max_j (n_j − j·gbs)`` smallest-slack items, where ``n_j`` counts
    items within ``j`` batches of their deadline, which keeps every
    future deadline feasible.  Soundness needs the window capacity
    ``W·gbs ≤ (max_staleness+1)·gbs`` (``max_staleness ≥ window − 1``,
    validated) and is why ``push`` refuses to overfill the window.

Composition is also *shape-aware*: each candidate's padded-shape bucket
(power-of-two row item count × power-of-two max media count — the compile
key a dynamic-padding input pipeline buckets by, cf.
``examples/train_mllm.build_batches``) is predicted from its LPT
partition, and candidates that would open a bucket no previous batch
compiled for are penalized by ``recompile_penalty``.  A FIFO loader on a
bursty stream walks through every intermediate mixture ratio and
compiles for each; the composer snaps batches onto the few buckets it
has already paid for.

A plan hot-swap invalidates the cached per-item durations
(``flush_plan()``, called by `RuntimeController.maybe_swap`); the
composer additionally re-checks the scheduler's plan identity on every
``compose()``, so composition never targets a stale θ* even if the
controller forgets to flush.

>>> e = [5.0, 1.0, 4.0, 2.0]                       # dominant durations
>>> sorted_runs(e, k=2, max_candidates=8)          # sorted: items 0,2,3,1
[(0, 2), (2, 3), (3, 1)]
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pipeline.simulator import simulate_bucket_ranks_batch
from repro_torch.core.scheduler.lpt import lpt_assign_batch
from repro_torch.data.items import DataItem


def sorted_runs(dominant: Sequence[float], k: int,
                max_candidates: int = 64) -> List[Tuple[int, ...]]:
    """Candidate index groups: contiguous length-``k`` runs of the items
    sorted by descending dominant duration.

    Contiguous runs in sorted order are the maximally homogeneous subsets
    — a run never skips an intermediate item, so its internal spread is
    minimal, which is what makes it balanceable into equal buckets.  When
    there are more runs than ``max_candidates`` they are strided evenly
    (first and last run always included).
    """
    order = np.argsort(-np.asarray(dominant, dtype=np.float64),
                       kind="stable")
    n = len(order)
    if k <= 0 or n < k:
        return []
    starts = np.arange(n - k + 1)
    if len(starts) > max_candidates:
        starts = np.unique(np.linspace(0, n - k, max_candidates,
                                       dtype=np.int64))
    return [tuple(int(j) for j in order[s:s + k]) for s in starts]


def edf_forced_count(slack: Sequence[int], per_step: int) -> int:
    """How many smallest-slack entries an EDF reservation must ship *now*
    to keep every future deadline feasible.

    ``slack[i]`` is the number of emission steps entry ``i`` can still
    wait (0 = must go in the next batch; negative clamps to 0) and
    ``per_step`` entries leave per step.  With ``n_j`` = count of entries
    within ``j`` steps of their deadline, feasibility of *all* deadlines
    needs ``max_j (n_j − j·per_step)`` departures immediately — forcing
    only slack-0 entries is not enough when many entries age in lockstep.
    Shared by the training-side `LookaheadComposer` (staleness deadlines)
    and the serving-side SLO admission (latency deadlines), so the two
    control loops cannot drift apart on the reservation rule.

    >>> edf_forced_count([0, 0, 1, 5], per_step=2)
    2
    >>> edf_forced_count([1, 1, 5, 5], per_step=2)   # next step fits both
    0
    >>> edf_forced_count([0, 10**9], per_step=1)     # huge slack: O(n) mem
    1
    """
    slack = np.maximum(np.asarray(slack, dtype=np.int64), 0)
    n = len(slack)
    if n == 0:
        return 0
    # `np.bincount` allocates O(max slack) — one relaxed deadline (slack
    # ~1e9) would allocate gigabytes.  Beyond the forcing horizon
    # H = ceil(n/per_step) slack can never force: for j >= H,
    # n_j − j·per_step <= n − n <= 0, so clipping to H changes no j < H
    # term and adds only non-positive ones — the count is exact.
    horizon = -(-n // max(int(per_step), 1))
    slack = np.minimum(slack, horizon)
    n_j = np.cumsum(np.bincount(slack))
    return int(max(0, (n_j - np.arange(len(n_j)) * per_step).max()))


def _pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1).

    >>> [_pow2(x) for x in (0, 1, 2, 3, 9)]
    [1, 1, 2, 4, 16]
    """
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclass
class ComposeStats:
    """Telemetry of one ``compose()`` call (mirrored into the runtime
    trace/metrics when the composer is attached to a `RuntimeController`)."""

    batch_idx: int
    window_fill: int             # items in the window before composing
    n_forced: int                # staleness-forced inclusions
    n_candidates: int
    chosen_makespan_s: float     # predicted step makespan of the pick
    fifo_makespan_s: float       # same metric for the FIFO candidate
    chosen_score: float          # work-normalized makespan (lower=better)
    fifo_score: float
    max_age: int                 # oldest emitted item's age, in batches
    elapsed_s: float
    shape_key: tuple = ()        # (rows_pow2, media_pow2) compile bucket
    novel_shape: bool = False    # batch opened a new compile bucket

    @property
    def pred_gain(self) -> float:
        """Predicted FIFO-over-chosen step-makespan ratio (>1 = the
        composed batch is predicted cheaper than the FIFO draw)."""
        return self.fifo_makespan_s / max(self.chosen_makespan_s, 1e-12)


class _Entry:
    __slots__ = ("item", "age", "e", "l")

    def __init__(self, item: DataItem):
        self.item = item
        self.age = 0                 # compose() calls survived in-window
        self.e = -1.0                # cached durations under the active
        self.l = -1.0                # plan; <0 = not computed / flushed


class LookaheadComposer:
    """Compose global batches from a bounded lookahead window.

    ``scheduler`` is an `OnlineMicrobatchScheduler` (duck-typed: the
    composer uses its ``plan`` and ``item_durations``) — predictions
    therefore flow through adaptive correction + online calibration
    exactly as schedule-time predictions do.
    """

    def __init__(self, scheduler, *, gbs: int, window: int = 4,
                 max_staleness: Optional[int] = None,
                 max_candidates: int = 64, score: str = "work-normalized",
                 recompile_penalty: float = 0.15,
                 bwd_over_fwd: float = 2.0):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if score not in ("work-normalized", "makespan"):
            raise ValueError(f"score must be 'work-normalized' or "
                             f"'makespan', got {score!r}")
        self.scheduler = scheduler
        self.gbs = gbs
        self.window = window
        # Default: an item may sit out one full window turnover in each
        # direction before it is forced out.
        self.max_staleness = (2 * window if max_staleness is None
                              else max_staleness)
        if self.max_staleness < max(window - 1, 1):
            # capacity argument: all W·gbs in-window items could be within
            # max_staleness batches of their deadline simultaneously, and
            # only gbs leave per batch
            raise ValueError(
                f"max_staleness must be >= max(window - 1, 1) = "
                f"{max(window - 1, 1)}, got {self.max_staleness}")
        self.max_candidates = max_candidates
        self.score = score
        # relative score penalty for opening a compile bucket no previous
        # batch used (0 disables shape-aware composition)
        self.recompile_penalty = recompile_penalty
        self.bwd_over_fwd = bwd_over_fwd
        self._entries: List[_Entry] = []
        self._seen_shapes: set = set()
        self._plan_key = None
        self.batch_idx = 0
        self.n_flushes = 0
        self.last_stats: Optional[ComposeStats] = None
        # optional runtime hooks, attached by RuntimeController
        self.trace = None
        self.metrics = None

    # ------------------------------------------------------------------ #
    @property
    def capacity(self) -> int:
        return self.window * self.gbs

    @property
    def pending(self) -> int:
        """Items currently held back in the window."""
        return len(self._entries)

    @property
    def ready(self) -> bool:
        """Window full — steady-state trigger: push one global batch,
        then compose while ready (the loader's loop)."""
        return len(self._entries) >= self.capacity

    def push(self, items: Sequence[DataItem]) -> None:
        """Admit items into the window.  Overfilling past ``window·gbs``
        would void the staleness guarantee (the EDF reservation's
        capacity argument needs at most ``(max_staleness+1)·gbs`` items
        in flight), so it is rejected — compose first."""
        if len(self._entries) + len(items) > self.capacity:
            raise ValueError(
                f"push of {len(items)} items would overfill the window "
                f"({len(self._entries)}/{self.capacity}); compose() "
                f"batches out first")
        self._entries.extend(_Entry(it) for it in items)

    def flush_plan(self) -> None:
        """Invalidate cached durations after a plan hot-swap, so the next
        ``compose()`` re-prices the whole window under the new θ*."""
        for en in self._entries:
            en.e = en.l = -1.0
        self._plan_key = None
        self.n_flushes += 1

    # ------------------------------------------------------------------ #
    def _refresh_durations(self) -> None:
        plan = self.scheduler.plan
        key = plan.as_tuple()
        if key != self._plan_key:
            # plan changed under us (hot-swap without flush_plan) — never
            # compose against a stale θ*
            for en in self._entries:
                en.e = en.l = -1.0
            self._plan_key = key
        fresh = [en for en in self._entries if en.e < 0.0]
        if not fresh:
            return
        e, l = self.scheduler.item_durations([en.item for en in fresh])
        for en, ei, li in zip(fresh, e, l):
            en.e = float(ei)
            en.l = float(li)

    def _score_candidates(self, cands: List[Tuple[int, ...]],
                          e: np.ndarray, l: np.ndarray,
                          media: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, List[tuple]]:
        """(makespan, score, shape_key) per candidate — one LPT + one
        schedule wavefront (the plan's own family) over the candidate set."""
        plan = self.scheduler.plan
        idx = np.asarray(cands, dtype=np.int64)
        e_s, l_s = e[idx], l[idx]                      # (C, n)
        m = plan.n_buckets
        assign, e_b, l_b = lpt_assign_batch(e_s, l_s, m)
        e_pp = plan.encoder.pp if plan.encoder else 0
        tr = simulate_bucket_ranks_batch(
            e_b, l_b, n_mb=plan.n_mb, dp=plan.llm.dp, e_pp=e_pp,
            l_pp=plan.llm.pp, bwd_over_fwd=self.bwd_over_fwd,
            backward=(getattr(self.scheduler, "mode", "train") == "train"),
            schedule=plan.schedule)
        makespan = tr.makespan.max(axis=-1)            # slowest dp rank
        if self.score == "makespan":
            scores = makespan.copy()
        else:
            # work-normalized: predicted step time per second of compute
            # the batch retires (1/utilization up to the chip count)
            busy = tr.stage_busy.sum(axis=(-2, -1))
            scores = makespan / np.maximum(busy, 1e-12)
        # compile bucket per candidate: pow2 of the fattest LPT row ×
        # pow2 of the batch's max media count — what a dynamic-padding
        # pipeline keys its jit cache on (train_mllm.build_batches)
        keys = []
        for c in range(assign.shape[0]):
            rows = int(np.bincount(assign[c], minlength=m).max())
            keys.append((_pow2(rows), _pow2(int(media[idx[c]].max()))))
        if self.recompile_penalty > 0.0:
            novel = np.array([k not in self._seen_shapes for k in keys])
            scores = scores * (1.0 + self.recompile_penalty * novel)
        return makespan, scores, keys

    def compose(self) -> List[DataItem]:
        """Emit one global batch (≤ gbs items; smaller only while
        draining a finite stream)."""
        if not self._entries:
            raise RuntimeError("compose() on an empty window")
        t0 = time.monotonic()
        self._refresh_durations()
        n = min(self.gbs, len(self._entries))
        window_fill = len(self._entries)
        # EDF reservation: slack = batches left before an entry's
        # deadline; n_j entries have slack <= j but only j·gbs seats
        # leave before then, so max_j (n_j − j·gbs) smallest-slack
        # entries must ship now to keep every deadline feasible (this
        # subsumes the "slack 0 goes now" rule and never exceeds gbs
        # while the window invariant n_j <= (j+1)·gbs holds)
        slack = np.array([self.max_staleness - en.age
                          for en in self._entries])
        need = edf_forced_count(slack, self.gbs)
        order = np.argsort(slack, kind="stable")      # ties: arrival order
        forced = sorted(int(i) for i in order[:min(need, n)])
        forced_set = set(forced)
        pool = [i for i in range(len(self._entries)) if i not in forced_set]
        k = n - len(forced)
        e = np.array([en.e for en in self._entries])
        l = np.array([en.l for en in self._entries])
        media = np.array([en.item.n_media_items for en in self._entries])
        # candidate 0 is always the FIFO draw (oldest k pool entries —
        # arrival order — on top of the forced prefix), so ties resolve
        # toward FIFO and the stats always carry the baseline's score
        cands: List[Tuple[int, ...]] = [tuple(forced) + tuple(pool[:k])]
        if k > 0:
            dominant = np.maximum(e, l)[pool]
            for run in sorted_runs(dominant, k, self.max_candidates):
                cands.append(tuple(forced) + tuple(pool[j] for j in run))
        makespan, scores, keys = self._score_candidates(cands, e, l, media)
        best = int(np.argmin(scores))
        chosen = cands[best]
        chosen_set = set(chosen)
        batch = [self._entries[i].item for i in chosen]
        max_age = max(self._entries[i].age for i in chosen)
        survivors = [en for i, en in enumerate(self._entries)
                     if i not in chosen_set]
        for en in survivors:
            en.age += 1
        self._entries = survivors
        novel = keys[best] not in self._seen_shapes
        self._seen_shapes.add(keys[best])
        self.last_stats = ComposeStats(
            batch_idx=self.batch_idx, window_fill=window_fill,
            n_forced=len(forced), n_candidates=len(cands),
            chosen_makespan_s=float(makespan[best]),
            fifo_makespan_s=float(makespan[0]),
            chosen_score=float(scores[best]), fifo_score=float(scores[0]),
            max_age=max_age, elapsed_s=time.monotonic() - t0,
            shape_key=keys[best], novel_shape=novel)
        self.batch_idx += 1
        self._record(self.last_stats)
        return batch

    def drain(self) -> Iterator[List[DataItem]]:
        """Empty the window at end of stream (exactly-once: the final
        batch may be smaller than gbs)."""
        while self._entries:
            yield self.compose()

    # ------------------------------------------------------------------ #
    def _record(self, st: ComposeStats) -> None:
        if self.trace is not None:
            self.trace.complete(
                "compose", self.trace.now_us() - st.elapsed_s * 1e6,
                st.elapsed_s * 1e6, cat="compose",
                args={"batch": st.batch_idx, "window_fill": st.window_fill,
                      "n_forced": st.n_forced, "max_age": st.max_age})
            self.trace.counter("compose_pred_gain", st.pred_gain)
            self.trace.counter("compose_window_fill", st.window_fill)
            self.trace.counter("compose_shape_buckets",
                               len(self._seen_shapes))
        if self.metrics is not None:
            self.metrics.record_compose(st)
