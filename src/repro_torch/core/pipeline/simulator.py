"""Discrete-event pipeline-schedule simulator (paper Fig. 1 / Fig. 13).

Computes exact start/end times for every (stage, microbatch, fwd/bwd) op of
a pipeline schedule given *per-microbatch, per-stage* durations — the
heterogeneous-cost generalization the paper studies.  Used to reproduce the
idle-time analysis (Fig. 13), stage-throughput distributions (Fig. 14) and
the end-to-end gains (Fig. 7) without hardware.

Two implementations share one definition of each schedule:

  * ``simulate_1f1b``       — the reference: a per-op event loop over one
                              (p, m) instance, recording the op list.
  * ``simulate_1f1b_batch`` — the production path: the same recurrence
                              evaluated as a vectorized wavefront over a
                              whole batch of instances at once (shape
                              ``(..., p, m)``, batched across e.g.
                              (trial, dp-rank)).  The search objectives and
                              the benchmark harness score through this one;
                              a property test pins it op-for-op to the
                              reference (`tests/test_simulator.py`).

Beyond 1F1B, the same split generalizes to the **schedule families** the
optimizer searches over (``docs/schedules.md``): the op DAG of a schedule
is *data* — a cached `ScheduleTopology` of (rank order, dependency lists,
topological evaluation order) — so every family shares one reference event
loop (`reference_schedule_times`) and one batched wavefront
(`simulate_schedule_batch`), pinned op-for-op against each other:

  * ``"interleaved"``  — Megatron-style interleaved 1F1B with ``v`` virtual
    model chunks per rank (`interleaved_topology`); the warmup/drain bubble
    shrinks by ``v``.  Needs ``m % p == 0``.
  * ``"encoder_fill"`` — Optimus-style encoder-in-bubble
    (`encoder_fill_topology`): the encoder is replicated across the LLM's
    ranks, each microbatch's encoder work splits into p chunks scheduled
    into the warmup (fwd chunks) and drain (bwd chunks) bubbles.

See ``docs/simulator.md`` for the wavefront derivation and the bucket→rank
convention.

1F1B static order per stage s (0-based, p stages, m microbatches):
    warmup w_s = min(m, p - s) forwards, then alternate (bwd, fwd) until
    forwards are exhausted, then drain backwards.
Dependencies:
    F[s, i] after F[s-1, i];  B[s, i] after B[s+1, i] and after F[s, i].
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# kept in sync with repro.core.optimizer.space.VIRTUAL_CHUNKS (this module
# stays import-free of the optimizer layer)
DEFAULT_VIRTUAL_CHUNKS = 2

Op = Tuple[str, int, int, float, float]          # (kind, stage, mb, t0, t1)


@dataclass
class PipelineTrace:
    makespan: float
    stage_busy: np.ndarray           # (p,) total compute time per stage
    stage_idle: np.ndarray           # (p,) makespan - busy
    # op list (kind, stage, mb, t0, t1); None when recording was disabled
    # (the batched scoring path — see `record_ops`) so large runs don't
    # allocate B·p·m Python tuples nobody reads.
    ops: Optional[List[Op]] = None

    @property
    def total_idle(self) -> float:
        return float(self.stage_idle.sum())

    @property
    def idle_fraction(self) -> float:
        p = len(self.stage_busy)
        return self.total_idle / max(p * self.makespan, 1e-12)

    def stage_throughput(self, stage_flops: np.ndarray) -> np.ndarray:
        """FLOP/s per stage over pure compute time (Fig. 14 metric)."""
        return stage_flops / np.maximum(self.stage_busy, 1e-12)


def simulate_1f1b(fwd: np.ndarray, bwd: np.ndarray | None = None) -> PipelineTrace:
    """Reference event-loop simulator for one instance.

    fwd/bwd: (p, m) per-stage per-microbatch durations (bwd default 2x).
    Always records the op list — it is the ground truth the batched
    implementation is property-tested against, and the entry point the
    figure scripts use when they need per-op spans.
    """
    fwd = np.asarray(fwd, dtype=np.float64)
    p, m = fwd.shape
    bwd = 2.0 * fwd if bwd is None else np.asarray(bwd, dtype=np.float64)

    orders = _static_orders(p, m)

    f_end = np.full((p, m), -1.0)
    b_end = np.full((p, m), -1.0)
    stage_t = np.zeros(p)
    ptr = [0] * p
    ops: List[Op] = []

    remaining = sum(len(o) for o in orders)
    progress = True
    while remaining > 0:
        if not progress:
            raise RuntimeError("1F1B schedule deadlocked (bug)")
        progress = False
        for s in range(p):
            while ptr[s] < len(orders[s]):
                kind, i = orders[s][ptr[s]]
                if kind == "F":
                    dep = f_end[s - 1, i] if s > 0 else 0.0
                    if dep < 0:
                        break
                    t0 = max(stage_t[s], dep)
                    t1 = t0 + fwd[s, i]
                    f_end[s, i] = t1
                else:
                    dep = b_end[s + 1, i] if s < p - 1 else f_end[s, i]
                    if dep < 0 or f_end[s, i] < 0:
                        break
                    t0 = max(stage_t[s], dep)
                    t1 = t0 + bwd[s, i]
                    b_end[s, i] = t1
                stage_t[s] = t1
                ops.append((kind, s, i, t0, t1))
                ptr[s] += 1
                remaining -= 1
                progress = True
    makespan = float(b_end.max())
    busy = fwd.sum(axis=1) + bwd.sum(axis=1)
    idle = makespan - busy
    return PipelineTrace(makespan, busy, idle, ops)


# --------------------------------------------------------------------- #
# batched wavefront implementation
# --------------------------------------------------------------------- #
@lru_cache(maxsize=None)
def _static_orders(p: int, m: int) -> Tuple[Tuple[Tuple[str, int], ...], ...]:
    """The 1F1B static op order of every stage, built once per (p, m)."""
    orders = []
    for s in range(p):
        w = min(m, p - s)
        seq: List[Tuple[str, int]] = [("F", i) for i in range(w)]
        nf, nb = w, 0
        while nf < m:
            seq.append(("B", nb)); nb += 1
            seq.append(("F", nf)); nf += 1
        while nb < m:
            seq.append(("B", nb)); nb += 1
        orders.append(tuple(seq))
    return tuple(orders)


@lru_cache(maxsize=None)
def _wavefront_order(p: int, m: int) -> Tuple[Tuple[int, bool, int], ...]:
    """A topological order of the 1F1B op DAG, shared by every instance of
    shape (p, m) — the durations never change the *structure*, only the
    times, which is what makes the batched evaluation possible.

    Walk op positions j = 0..2m−1 in lockstep across stages ("passes").
    Within the static order, the cross-stage dependency of the op at
    position j always sits at position j−1 or j of its neighbour stage:

      * F[s, i] ← F[s−1, i]: same position during warmup (both stages are
        in their first w ops), one earlier in steady state — so passes with
        j < m (where every same-position dependency is a warmup forward)
        resolve stage 0 first;
      * B[s, i] ← B[s+1, i]: one earlier in steady state, same position in
        the drain (which only occupies positions j ≥ m) — so those passes
        resolve the last stage first.

    Hence: pass j < m walks stages top-down, pass j ≥ m bottom-up, and
    every dependency is evaluated before its dependent.
    """
    orders = _static_orders(p, m)
    topo: List[Tuple[int, bool, int]] = []
    for j in range(2 * m):
        stages = range(p) if j < m else range(p - 1, -1, -1)
        for s in stages:
            kind, i = orders[s][j]
            topo.append((s, kind == "F", i))
    return tuple(topo)


@dataclass
class BatchPipelineTrace:
    """Vectorized `PipelineTrace` over a batch of (p, m) instances.

    All arrays carry the input's leading batch shape ``lead`` (e.g.
    ``(n_trials, dp)``): makespan is ``lead``, stage_busy/stage_idle are
    ``lead + (p,)``.  Op start/end times are only materialized under
    ``record_ops=True`` as four ``lead + (p, m)`` arrays — never as
    per-op Python tuples.
    """
    makespan: np.ndarray
    stage_busy: np.ndarray
    stage_idle: np.ndarray
    f_start: Optional[np.ndarray] = None
    f_end: Optional[np.ndarray] = None
    b_start: Optional[np.ndarray] = None
    b_end: Optional[np.ndarray] = None
    # generic-schedule recording (`simulate_schedule_batch`): per-op times
    # as ``lead + (n_ops,)`` arrays, op ids indexing the instance's
    # `ScheduleTopology.labels`.  The (p, m)-shaped f_*/b_* fields above
    # stay 1F1B-only (the op grid of the other families isn't (p, m)).
    op_start: Optional[np.ndarray] = None
    op_end: Optional[np.ndarray] = None

    @property
    def total_idle(self) -> np.ndarray:
        return self.stage_idle.sum(axis=-1)

    @property
    def idle_fraction(self) -> np.ndarray:
        p = self.stage_busy.shape[-1]
        return self.total_idle / np.maximum(p * self.makespan, 1e-12)

    def trace(self, index) -> PipelineTrace:
        """Scalar view of one instance (index into the leading batch
        shape).  Ops, when recorded, come back in static per-stage order
        rather than global start-time order."""
        ops = None
        if self.f_end is not None:
            p, m = self.f_end[index].shape
            ops = []
            for s, order in enumerate(_static_orders(p, m)):
                for kind, i in order:
                    t0s, t1s = ((self.f_start, self.f_end) if kind == "F"
                                else (self.b_start, self.b_end))
                    ops.append((kind, s, i, float(t0s[index][s, i]),
                                float(t1s[index][s, i])))
        return PipelineTrace(float(self.makespan[index]),
                             self.stage_busy[index],
                             self.stage_idle[index], ops)


def simulate_1f1b_batch(fwd: np.ndarray, bwd: np.ndarray | None = None,
                        *, record_ops: bool = False) -> BatchPipelineTrace:
    """Vectorized 1F1B simulation of a whole batch of instances.

    fwd/bwd: ``(..., p, m)`` per-stage per-microbatch durations (bwd
    default 2×fwd); the leading axes are independent instances — e.g.
    ``(n_trials, dp)`` when scoring Monte-Carlo trials across data-parallel
    ranks.  One call replaces ``prod(lead)`` reference-loop runs: the op
    DAG is identical for every instance, so each node of the cached
    wavefront order (`_wavefront_order`) is evaluated as a single
    max/add over the batch axis.  Start/end times equal the reference's
    bit-for-bit (same max/add, same association).

    >>> import numpy as np
    >>> fwd = np.ones((3, 2, 4))                  # 3 instances, p=2, m=4
    >>> tr = simulate_1f1b_batch(fwd)             # bwd defaults to 2*fwd
    >>> tr.makespan.shape
    (3,)
    >>> float(tr.makespan[0])                     # (m + p - 1) * 3
    15.0
    """
    fwd = np.asarray(fwd, dtype=np.float64)
    if fwd.ndim < 2:
        raise ValueError(f"fwd must be (..., p, m), got shape {fwd.shape}")
    lead = fwd.shape[:-2]
    p, m = fwd.shape[-2:]
    bwd = 2.0 * fwd if bwd is None else np.asarray(bwd, dtype=np.float64)
    if bwd.shape != fwd.shape:
        raise ValueError(f"bwd shape {bwd.shape} != fwd shape {fwd.shape}")
    fwd2 = np.ascontiguousarray(fwd.reshape((-1, p, m)))
    bwd2 = np.ascontiguousarray(bwd.reshape((-1, p, m)))
    # (p, m, B) layout: each op's batch vector is contiguous
    F = np.ascontiguousarray(np.moveaxis(fwd2, 0, -1))
    W = np.ascontiguousarray(np.moveaxis(bwd2, 0, -1))
    B = F.shape[-1]

    f_end = np.zeros((p, m, B))
    b_end = np.zeros((p, m, B))
    stage_t = np.zeros((p, B))
    rec = (np.zeros((2, 2, p, m, B)) if record_ops else None)  # [F/B][t0/t1]

    for s, is_f, i in _wavefront_order(p, m):
        if is_f:
            if s > 0:
                t0 = np.maximum(stage_t[s], f_end[s - 1, i])
            else:
                t0 = stage_t[s].copy()
            t1 = t0 + F[s, i]
            f_end[s, i] = t1
        else:
            dep = b_end[s + 1, i] if s < p - 1 else f_end[s, i]
            t0 = np.maximum(stage_t[s], dep)
            t1 = t0 + W[s, i]
            b_end[s, i] = t1
        stage_t[s] = t1
        if rec is not None:
            rec[0 if is_f else 1, :, s, i] = (t0, t1)

    makespan = b_end.reshape((p * m, B)).max(axis=0).reshape(lead)
    # summed over the contiguous m axis of the (B, p, m) layout, separately
    # per phase, so the float association (numpy's pairwise reduction)
    # matches the reference's fwd.sum(axis=1) + bwd.sum(axis=1) bit-for-bit
    busy = (fwd2.sum(axis=-1) + bwd2.sum(axis=-1)).reshape(lead + (p,))
    idle = makespan[..., None] - busy

    def _times(a):
        return np.moveaxis(a, -1, 0).reshape(lead + (p, m))

    return BatchPipelineTrace(
        makespan, busy, idle,
        f_start=_times(rec[0, 0]) if record_ops else None,
        f_end=_times(rec[0, 1]) if record_ops else None,
        b_start=_times(rec[1, 0]) if record_ops else None,
        b_end=_times(rec[1, 1]) if record_ops else None)


# --------------------------------------------------------------------- #
# schedule-family topologies (interleaved, encoder_fill)
# --------------------------------------------------------------------- #
# duration-source codes for ScheduleTopology.src
_SRC_FWD, _SRC_BWD, _SRC_EFWD, _SRC_EBWD = 0, 1, 2, 3


@dataclass(frozen=True)
class ScheduleTopology:
    """One schedule's op DAG as data, cached per (schedule, p, m, v).

    Every op is a node: ``labels[o] = (kind, rank, chunk, mb)`` with kind in
    {"F", "B", "EF", "EB"}.  ``rank_orders[r]`` is rank r's static execution
    order (op ids), ``deps[o]`` its cross-op dependencies, and ``order`` a
    linear extension of deps ∪ rank chains — the evaluation sequence both
    the reference event loop and the batched wavefront walk, so their
    max/add operands (and hence their float results) are identical.
    ``src/row/col/scale`` gather each op's duration from the caller's
    ``(p, m)`` arrays: ``dur[o] = arrays[src[o]][row[o], col[o]] · scale[o]``.
    """
    schedule: str
    p: int
    m: int
    v: int
    labels: Tuple[Tuple[str, int, int, int], ...]
    rank_orders: Tuple[Tuple[int, ...], ...]
    deps: Tuple[Tuple[int, ...], ...]
    order: Tuple[int, ...]
    rank: np.ndarray
    src: np.ndarray
    row: np.ndarray
    col: np.ndarray
    scale: np.ndarray

    @property
    def n_ops(self) -> int:
        return len(self.labels)


def _linear_order(rank_orders, deps, n_ops: int) -> Tuple[int, ...]:
    """Deterministic linear extension of deps ∪ rank chains (Kahn, smallest
    op id first).  Raises on a cyclic schedule — a topology-construction
    bug, caught at cache-build time rather than as a silent deadlock."""
    import heapq
    succ: List[List[int]] = [[] for _ in range(n_ops)]
    indeg = [0] * n_ops
    for o, ds in enumerate(deps):
        for d in ds:
            succ[d].append(o)
            indeg[o] += 1
    for seq in rank_orders:
        for a, b in zip(seq, seq[1:]):
            succ[a].append(b)
            indeg[b] += 1
    heap = [o for o in range(n_ops) if indeg[o] == 0]
    heapq.heapify(heap)
    out: List[int] = []
    while heap:
        o = heapq.heappop(heap)
        out.append(o)
        for s in succ[o]:
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(heap, s)
    if len(out) != n_ops:
        raise RuntimeError("schedule topology is cyclic (bug)")
    return tuple(out)


def _pack_topology(schedule: str, p: int, m: int, v: int, labels, rank_orders,
                   deps, srcs, rows, cols, scales) -> ScheduleTopology:
    return ScheduleTopology(
        schedule, p, m, v, tuple(labels),
        tuple(tuple(s) for s in rank_orders),
        tuple(tuple(d) for d in deps),
        _linear_order(rank_orders, deps, len(labels)),
        rank=np.array([lb[1] for lb in labels], dtype=np.int64),
        src=np.asarray(srcs, dtype=np.int64),
        row=np.asarray(rows, dtype=np.int64),
        col=np.asarray(cols, dtype=np.int64),
        scale=np.asarray(scales, dtype=np.float64))


@lru_cache(maxsize=None)
def interleaved_topology(p: int, m: int,
                         v: int = DEFAULT_VIRTUAL_CHUNKS) -> ScheduleTopology:
    """Megatron-style interleaved 1F1B with ``v`` virtual chunks per rank.

    Virtual stage k = c·p + s lives on rank s = k mod p; microbatches are
    walked in groups of p (``m % p == 0`` required).  Rank s runs
    ``min(m·v, 2(p−s−1) + (v−1)p)`` warmup forwards, then steady (F, B)
    pairs, then drains.  Per-chunk durations are the rank's stage duration
    divided by v (``scale = 1/v``): the same layers, cut v ways.

    Dependencies: F[c,s,i] ← F[c,s−1,i] (within chunk) or F[c−1,p−1,i]
    (chunk boundary); B mirrors downward, rooted at its own F[v−1,p−1,i];
    every B[c,s,i] also requires its own F[c,s,i].
    """
    if p < 1 or m < 1:
        raise ValueError(f"need p, m >= 1, got p={p}, m={m}")
    if v < 2:
        raise ValueError(f"interleaved needs v >= 2 chunks, got {v}")
    if m % p:
        raise ValueError(f"interleaved needs m % p == 0, got m={m}, p={p}")
    total = m * v                       # virtual microbatches per rank
    labels, srcs, rows, cols, scales = [], [], [], [], []
    fid: Dict[Tuple[int, int, int], int] = {}
    bid: Dict[Tuple[int, int, int], int] = {}

    def _add(kind, s, c, i, src):
        labels.append((kind, s, c, i))
        srcs.append(src); rows.append(s); cols.append(i)
        scales.append(1.0 / v)
        return len(labels) - 1

    for c in range(v):
        for s in range(p):
            for i in range(m):
                fid[(c, s, i)] = _add("F", s, c, i, _SRC_FWD)
    for c in range(v):
        for s in range(p):
            for i in range(m):
                bid[(c, s, i)] = _add("B", s, c, i, _SRC_BWD)

    deps: List[List[int]] = [[] for _ in labels]
    for (c, s, i), o in fid.items():
        if s > 0:
            deps[o].append(fid[(c, s - 1, i)])
        elif c > 0:
            deps[o].append(fid[(c - 1, p - 1, i)])
    for (c, s, i), o in bid.items():
        deps[o].append(fid[(c, s, i)])
        if s < p - 1:
            deps[o].append(bid[(c, s + 1, i)])
        elif c < v - 1:
            deps[o].append(bid[(c + 1, 0, i)])

    def _vmb(x: int, forward: bool) -> Tuple[int, int]:
        """x-th virtual microbatch of a rank → (chunk, microbatch)."""
        within = x % (p * v)
        c = within // p
        if not forward:
            c = v - 1 - c
        return c, (x // (p * v)) * p + within % p

    rank_orders: List[List[int]] = []
    for s in range(p):
        warm = min(total, 2 * (p - s - 1) + (v - 1) * p)
        seq: List[int] = []
        nf = nb = 0
        while nf < warm:
            c, i = _vmb(nf, True); seq.append(fid[(c, s, i)]); nf += 1
        while nf < total:
            c, i = _vmb(nf, True); seq.append(fid[(c, s, i)]); nf += 1
            c, i = _vmb(nb, False); seq.append(bid[(c, s, i)]); nb += 1
        while nb < total:
            c, i = _vmb(nb, False); seq.append(bid[(c, s, i)]); nb += 1
        rank_orders.append(seq)

    return _pack_topology("interleaved", p, m, v, labels, rank_orders, deps,
                          srcs, rows, cols, scales)


@lru_cache(maxsize=None)
def encoder_fill_topology(p: int, m: int) -> ScheduleTopology:
    """Optimus-style encoder-in-bubble over a p-stage LLM 1F1B skeleton.

    The encoder holds no pipeline stages: each of the p LLM ranks hosts a
    replica and runs one encoder chunk per microbatch (durations come from
    the ``e_fwd``/``e_bwd`` arrays, already per-chunk).  Chunk placement
    fills the 1F1B bubbles statically:

      * EF[s,i] runs just before F[s, max(i−s, 0)] — rank s's warmup idle
        absorbs its first s+1 chunks, later chunks slot one forward ahead;
      * EB[s,i] runs just after B[s, min(i+s, m−1)] — the mirror image in
        the drain.

    Dependencies: F[0,i] ← EF[s,i] for every rank s (the LLM consumes the
    full encoder output), EB[s,i] ← B[0,i] (encoder backward needs the
    LLM's input gradient), plus the plain 1F1B deps.  Deadlock-freedom:
    every dependency chain strictly decreases in microbatch index (see
    docs/schedules.md); the reference event loop raises if violated.
    """
    if p < 1 or m < 1:
        raise ValueError(f"need p, m >= 1, got p={p}, m={m}")
    labels, srcs, rows, cols, scales = [], [], [], [], []

    def _add(kind, s, i, src):
        labels.append((kind, s, 0, i))
        srcs.append(src); rows.append(s); cols.append(i)
        scales.append(1.0)
        return len(labels) - 1

    fid = {(s, i): _add("F", s, i, _SRC_FWD)
           for s in range(p) for i in range(m)}
    bid = {(s, i): _add("B", s, i, _SRC_BWD)
           for s in range(p) for i in range(m)}
    efid = {(s, i): _add("EF", s, i, _SRC_EFWD)
            for s in range(p) for i in range(m)}
    ebid = {(s, i): _add("EB", s, i, _SRC_EBWD)
            for s in range(p) for i in range(m)}

    deps: List[List[int]] = [[] for _ in labels]
    for (s, i), o in fid.items():
        if s > 0:
            deps[o].append(fid[(s - 1, i)])
        else:
            deps[o].extend(efid[(r, i)] for r in range(p))
    for (s, i), o in bid.items():
        deps[o].append(fid[(s, i)])
        if s < p - 1:
            deps[o].append(bid[(s + 1, i)])
    for (s, i), o in ebid.items():
        deps[o].append(bid[(0, i)])

    ef_before: Dict[Tuple[int, int], List[int]] = {}
    eb_after: Dict[Tuple[int, int], List[int]] = {}
    for s in range(p):
        for i in range(m):
            ef_before.setdefault((s, max(i - s, 0)), []).append(efid[(s, i)])
            eb_after.setdefault((s, min(i + s, m - 1)), []).append(ebid[(s, i)])

    rank_orders: List[List[int]] = []
    for s, order in enumerate(_static_orders(p, m)):
        seq: List[int] = []
        for kind, i in order:
            if kind == "F":
                seq.extend(ef_before.get((s, i), ()))
                seq.append(fid[(s, i)])
            else:
                seq.append(bid[(s, i)])
                seq.extend(eb_after.get((s, i), ()))
        rank_orders.append(seq)

    return _pack_topology("encoder_fill", p, m, 1, labels, rank_orders,
                          deps, srcs, rows, cols, scales)


def schedule_topology(schedule: str, p: int, m: int, *,
                      v: int = DEFAULT_VIRTUAL_CHUNKS) -> ScheduleTopology:
    """Cached topology for one (schedule, p, m[, v]) instance shape."""
    if schedule == "interleaved":
        return interleaved_topology(p, m, v)
    if schedule == "encoder_fill":
        return encoder_fill_topology(p, m)
    raise ValueError(f"no generic topology for schedule {schedule!r} "
                     f"(1f1b uses the dedicated wavefront)")


def _op_durations(topo: ScheduleTopology, fwd: np.ndarray, bwd: np.ndarray,
                  e_fwd: Optional[np.ndarray],
                  e_bwd: Optional[np.ndarray]) -> np.ndarray:
    """(n_ops, B) per-op durations gathered from (p, m, B) source arrays —
    one shared gather so the reference and the batch see identical floats."""
    arrays = {_SRC_FWD: fwd, _SRC_BWD: bwd, _SRC_EFWD: e_fwd,
              _SRC_EBWD: e_bwd}
    B = fwd.shape[-1]
    dur = np.empty((topo.n_ops, B))
    for code, arr in arrays.items():
        sel = topo.src == code
        if not sel.any():
            continue
        if arr is None:
            raise ValueError(f"schedule {topo.schedule!r} needs encoder "
                             f"duration arrays")
        dur[sel] = arr[topo.row[sel], topo.col[sel], :] \
            * topo.scale[sel][:, None]
    return dur


def _rank_busy(topo: ScheduleTopology, dur: np.ndarray) -> np.ndarray:
    """(p, B) per-rank busy time: each rank's ops summed in static order
    via one `np.add.reduce` — shared by both implementations so the float
    association can never differ between them."""
    B = dur.shape[-1]
    busy = np.zeros((topo.p, B))
    for r, seq in enumerate(topo.rank_orders):
        if seq:
            busy[r] = np.add.reduce(dur[list(seq)], axis=0)
    return busy


def reference_schedule_times(topo: ScheduleTopology, fwd: np.ndarray,
                             bwd: np.ndarray,
                             e_fwd: Optional[np.ndarray] = None,
                             e_bwd: Optional[np.ndarray] = None,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-op reference event loop over one instance (all arrays (p, m)).

    Walks each rank's static order behind per-rank pointers, firing an op
    once all its dependencies have finished — the ground truth the batched
    wavefront is property-pinned against.  Returns (start, end) arrays
    indexed by op id; raises RuntimeError if the schedule deadlocks.
    """
    def _col(a):
        return None if a is None else \
            np.asarray(a, dtype=np.float64)[:, :, None]
    dur = _op_durations(topo, _col(fwd), _col(bwd), _col(e_fwd),
                        _col(e_bwd))[:, 0]
    start = np.full(topo.n_ops, -1.0)
    end = np.full(topo.n_ops, -1.0)
    rank_t = np.zeros(topo.p)
    ptr = [0] * topo.p
    remaining = topo.n_ops
    progress = True
    while remaining > 0:
        if not progress:
            raise RuntimeError(
                f"{topo.schedule} schedule deadlocked (bug)")
        progress = False
        for s in range(topo.p):
            seq = topo.rank_orders[s]
            while ptr[s] < len(seq):
                o = seq[ptr[s]]
                ds = topo.deps[o]
                if any(end[d] < 0 for d in ds):
                    break
                t0 = rank_t[s]
                for d in ds:
                    t0 = max(t0, end[d])
                t1 = t0 + dur[o]
                start[o], end[o] = t0, t1
                rank_t[s] = t1
                ptr[s] += 1
                remaining -= 1
                progress = True
    return start, end


def simulate_schedule_batch(schedule: str, fwd: np.ndarray,
                            bwd: Optional[np.ndarray] = None, *,
                            e_fwd: Optional[np.ndarray] = None,
                            e_bwd: Optional[np.ndarray] = None,
                            v: int = DEFAULT_VIRTUAL_CHUNKS,
                            record_ops: bool = False) -> "BatchPipelineTrace":
    """Vectorized wavefront over a batch of instances of any schedule.

    fwd/bwd (and, for ``encoder_fill``, e_fwd/e_bwd — already per-rank
    *chunk* durations): ``(..., p, m)`` arrays with independent leading
    batch axes.  ``schedule="1f1b"`` dispatches to the dedicated
    `simulate_1f1b_batch` wavefront unchanged (bit-for-bit the historical
    path); the generic families walk the cached `ScheduleTopology` in its
    linear order — each op one max/add over the batch axis, exactly the
    operands of `reference_schedule_times`.  With ``record_ops`` the trace
    carries ``op_start``/``op_end`` as ``lead + (n_ops,)`` arrays (op ids
    index `schedule_topology(...)`'s labels).
    """
    fwd = np.asarray(fwd, dtype=np.float64)
    if fwd.ndim < 2:
        raise ValueError(f"fwd must be (..., p, m), got shape {fwd.shape}")
    bwd = 2.0 * fwd if bwd is None else np.asarray(bwd, dtype=np.float64)
    if schedule == "1f1b":
        if e_fwd is not None or e_bwd is not None:
            raise ValueError("1f1b takes encoder stages via fwd/bwd rows, "
                             "not e_fwd/e_bwd")
        return simulate_1f1b_batch(fwd, bwd, record_ops=record_ops)
    lead = fwd.shape[:-2]
    p, m = fwd.shape[-2:]
    topo = schedule_topology(schedule, p, m, v=v)

    def _layout(a):
        if a is None:
            return None
        a = np.asarray(a, dtype=np.float64)
        if a.shape != fwd.shape:
            raise ValueError(f"duration array shape {a.shape} != {fwd.shape}")
        return np.ascontiguousarray(
            np.moveaxis(a.reshape((-1, p, m)), 0, -1))

    F, W = _layout(fwd), _layout(bwd)
    EF, EW = _layout(e_fwd), _layout(e_bwd)
    B = F.shape[-1]
    dur = _op_durations(topo, F, W, EF, EW)

    end = np.zeros((topo.n_ops, B))
    start = np.zeros((topo.n_ops, B)) if record_ops else None
    rank_t = np.zeros((topo.p, B))
    for o in topo.order:
        r = topo.rank[o]
        t0 = rank_t[r]
        for d in topo.deps[o]:
            t0 = np.maximum(t0, end[d])
        t1 = t0 + dur[o]
        if start is not None:
            start[o] = t0
        end[o] = t1
        rank_t[r] = t1

    makespan = end.max(axis=0).reshape(lead)
    busy = np.moveaxis(_rank_busy(topo, dur), -1, 0).reshape(lead + (p,))
    idle = makespan[..., None] - busy
    return BatchPipelineTrace(
        makespan, busy, idle,
        op_start=(np.moveaxis(start, -1, 0).reshape(lead + (topo.n_ops,))
                  if record_ops else None),
        op_end=(np.moveaxis(end, -1, 0).reshape(lead + (topo.n_ops,))
                if record_ops else None))


def _topo_trace(topo: ScheduleTopology, start: np.ndarray,
                end: np.ndarray, dur: np.ndarray) -> PipelineTrace:
    """Assemble a scalar `PipelineTrace` from reference per-op times."""
    ops = [(topo.labels[o][0], int(topo.labels[o][1]),
            int(topo.labels[o][3]), float(start[o]), float(end[o]))
           for s in range(topo.p) for o in topo.rank_orders[s]]
    busy = _rank_busy(topo, dur[:, None])[:, 0]
    makespan = float(end.max())
    return PipelineTrace(makespan, busy, makespan - busy, ops)


def simulate_interleaved(fwd: np.ndarray, bwd: np.ndarray | None = None, *,
                         v: int = DEFAULT_VIRTUAL_CHUNKS) -> PipelineTrace:
    """Reference interleaved-1F1B simulation of one (p, m) instance.

    fwd/bwd: (p, m) full per-rank stage durations (each virtual chunk costs
    1/v of its rank's row); bwd defaults to 2×fwd.  Op list entries are
    (kind, rank, mb, t0, t1) with v ops per (kind, rank, mb) triple.
    """
    fwd = np.asarray(fwd, dtype=np.float64)
    p, m = fwd.shape
    bwd = 2.0 * fwd if bwd is None else np.asarray(bwd, dtype=np.float64)
    topo = interleaved_topology(p, m, v)
    start, end = reference_schedule_times(topo, fwd, bwd)
    dur = _op_durations(topo, fwd[:, :, None], bwd[:, :, None],
                        None, None)[:, 0]
    return _topo_trace(topo, start, end, dur)


def simulate_encoder_fill(fwd: np.ndarray, bwd: np.ndarray,
                          e_fwd: np.ndarray,
                          e_bwd: np.ndarray) -> PipelineTrace:
    """Reference encoder-in-bubble simulation of one (p, m) instance.

    fwd/bwd: (p, m) LLM stage durations; e_fwd/e_bwd: (p, m) *per-rank
    encoder chunk* durations (a microbatch's total encoder cost split over
    the p replicas).  Ops "EF"/"EB" are the bubble-filling chunks.
    """
    fwd = np.asarray(fwd, dtype=np.float64)
    p, m = fwd.shape
    topo = encoder_fill_topology(p, m)
    start, end = reference_schedule_times(topo, fwd, bwd, e_fwd, e_bwd)
    dur = _op_durations(topo, fwd[:, :, None],
                        np.asarray(bwd, np.float64)[:, :, None],
                        np.asarray(e_fwd, np.float64)[:, :, None],
                        np.asarray(e_bwd, np.float64)[:, :, None])[:, 0]
    return _topo_trace(topo, start, end, dur)


# --------------------------------------------------------------------- #
# scheduler-bucket → pipeline-rank convention
# --------------------------------------------------------------------- #
def bucket_rank_durations(e_b: np.ndarray, l_b: np.ndarray, *, n_mb: int,
                          dp: int, e_pp: int, l_pp: int) -> np.ndarray:
    """Scheduler bucket durations → per-rank stage rows, vectorized.

    e_b/l_b: ``(..., n_mb · dp)`` per-bucket encoder/LLM durations (already
    per-stage, i.e. divided by the module's PP degree).  Returns
    ``(..., dp, p, n_mb)`` rows where ``p = e_pp + l_pp``: bucket
    ``i·dp + r`` is microbatch i of data-parallel rank r (the order the
    data loader consumes `ScheduleOutput.groups`), each encoder stage takes
    the bucket's encoder value and each LLM stage its LLM value.
    """
    e_b = np.asarray(e_b, dtype=np.float64)
    l_b = np.asarray(l_b, dtype=np.float64)
    lead = l_b.shape[:-1]
    p = e_pp + l_pp
    rows = np.empty(lead + (dp, p, n_mb))
    # (..., n_mb·dp) → (..., n_mb, dp) → (..., dp, n_mb); broadcast over
    # the module's stages
    l_ri = np.moveaxis(l_b.reshape(lead + (n_mb, dp)), -1, -2)
    rows[..., e_pp:, :] = l_ri[..., None, :]
    if e_pp:
        e_ri = np.moveaxis(e_b.reshape(lead + (n_mb, dp)), -1, -2)
        rows[..., :e_pp, :] = e_ri[..., None, :]
    return rows


def simulate_bucket_ranks_batch(e_b: np.ndarray, l_b: np.ndarray, *,
                                n_mb: int, dp: int, e_pp: int, l_pp: int,
                                bwd_over_fwd: float = 2.0,
                                backward: bool = True,
                                record_ops: bool = False,
                                schedule: str = "1f1b",
                                virtual_chunks: int = DEFAULT_VIRTUAL_CHUNKS,
                                ) -> BatchPipelineTrace:
    """Batched schedule traces for scheduler buckets; see
    `simulate_bucket_ranks` for the convention.  e_b/l_b may carry leading
    batch axes (e.g. one per Monte-Carlo trial); the result's batch shape
    is ``lead + (dp,)`` and the slowest rank per instance is
    ``out.makespan.max(axis=-1)``.

    ``schedule`` selects the family (``ParallelismPlan.schedule``):

      * ``"1f1b"`` — the historical path, unchanged bit-for-bit;
      * ``"interleaved"`` — same per-rank rows, walked as ``virtual_chunks``
        virtual stages per rank (needs ``n_mb % (e_pp + l_pp) == 0``);
      * ``"encoder_fill"`` — ``e_b`` holds each bucket's *full* encoder
        duration (the scheduler's per-item ``e_dur`` under the colocated
        plan, summed); it is split evenly into ``l_pp`` per-rank chunks and
        scheduled into the LLM bubbles (``e_pp`` is ignored — the encoder
        holds no stages).
    """
    if schedule == "encoder_fill":
        lead = np.asarray(l_b, dtype=np.float64).shape[:-1]
        rows = bucket_rank_durations(
            np.zeros_like(np.asarray(l_b, dtype=np.float64)), l_b,
            n_mb=n_mb, dp=dp, e_pp=0, l_pp=l_pp)
        e_rows = bucket_rank_durations(
            np.zeros_like(np.asarray(e_b, dtype=np.float64)), e_b,
            n_mb=n_mb, dp=dp, e_pp=0, l_pp=l_pp) / l_pp
        if backward:
            fwd = rows / (1.0 + bwd_over_fwd)
            bwd = bwd_over_fwd * fwd
            e_fwd = e_rows / (1.0 + bwd_over_fwd)
            e_bwd = bwd_over_fwd * e_fwd
        else:
            fwd, bwd = rows, 0.0 * rows
            e_fwd, e_bwd = e_rows, 0.0 * e_rows
        return simulate_schedule_batch("encoder_fill", fwd, bwd,
                                       e_fwd=e_fwd, e_bwd=e_bwd,
                                       record_ops=record_ops)
    rows = bucket_rank_durations(e_b, l_b, n_mb=n_mb, dp=dp, e_pp=e_pp,
                                 l_pp=l_pp)
    if backward:
        fwd = rows / (1.0 + bwd_over_fwd)
        bwd = bwd_over_fwd * fwd
    else:
        fwd, bwd = rows, 0.0 * rows
    if schedule == "1f1b":
        return simulate_1f1b_batch(fwd, bwd, record_ops=record_ops)
    return simulate_schedule_batch(schedule, fwd, bwd, v=virtual_chunks,
                                   record_ops=record_ops)


def simulate_bucket_ranks(e_b: np.ndarray, l_b: np.ndarray, *, n_mb: int,
                          dp: int, e_pp: int, l_pp: int,
                          bwd_over_fwd: float = 2.0, backward: bool = True,
                          record_ops: bool = False, schedule: str = "1f1b"):
    """Per-rank schedule traces for m = n_mb · dp scheduler buckets.

    This is THE convention shared by the search objectives
    (`objective._SamplingObjective`) and the benchmark harness
    (`benchmarks.common.simulate_iteration`) — keep it in one place so
    predicted and "ground truth" simulations can never drift:

      * bucket i·dp + r is microbatch i of data-parallel rank r (the order
        the data loader consumes `ScheduleOutput.groups`);
      * bucket durations are per-stage (already divided by the module's PP
        degree): each of the module's stages takes the bucket value as-is;
      * with `backward`, durations are full fwd+bwd cost and are split
        1 : bwd_over_fwd over the 1F1B phases (so a homogeneous batch
        reproduces the closed form (n_mb + p − 1) · c); without, they are
        forward-only.

    Yields one `PipelineTrace` per rank (all dp ranks are simulated in a
    single `simulate_1f1b_batch` call; per-op spans only with
    `record_ops=True`).
    """
    batch = simulate_bucket_ranks_batch(
        e_b, l_b, n_mb=n_mb, dp=dp, e_pp=e_pp, l_pp=l_pp,
        bwd_over_fwd=bwd_over_fwd, backward=backward, record_ops=record_ops,
        schedule=schedule)
    for r in range(dp):
        yield batch.trace(r)


def ideal_bubble_fraction(p: int, m: int) -> float:
    """Theoretical 1F1B bubble (p−1)/m ... /(m + p − 1) of the makespan for
    homogeneous microbatches (paper cites (p−1)/m [Megatron]).

    >>> ideal_bubble_fraction(4, 12)
    0.2
    """
    return (p - 1) / (m + p - 1)
