"""Longest-Processing-Time fallback heuristic (paper §3.4.2, Graham 1969).

Generalized to DFLOP's two-stage objective: each item carries an
(encoder, LLM) duration pair and the bucket cost is max(E_j, L_j); LPT
sorts by the dominant duration and greedily assigns each item to the bucket
whose resulting bottleneck is smallest.  O(N·log m) with a heap when only
one stage matters; O(N·m) in the general coupled case (still microseconds
at GBS 2048).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def lpt_schedule(e_dur: Sequence[float], l_dur: Sequence[float],
                 m: int, refine: bool = True) -> List[List[int]]:
    """Partition items into m buckets. Returns index groups.

    `refine` adds a bounded move-from-bottleneck local search — at GBS 2048
    this is what keeps the fallback within 1% of the lower bound (Fig. 16b).
    """
    e = np.asarray(e_dur, dtype=np.float64)
    l = np.asarray(l_dur, dtype=np.float64)
    n = len(e)
    order = np.argsort(-(np.maximum(e, l)))
    loads_e = np.zeros(m)
    loads_l = np.zeros(m)
    groups: List[List[int]] = [[] for _ in range(m)]
    for i in order:
        cand = np.maximum(loads_e + e[i], loads_l + l[i])
        j = int(np.argmin(cand))
        loads_e[j] += e[i]
        loads_l[j] += l[i]
        groups[j].append(int(i))
    if not refine or n == 0:
        return groups
    # local search: move any item out of the bottleneck bucket if that
    # strictly lowers the global C_max
    for _ in range(4 * m):
        cur = np.maximum(loads_e, loads_l)
        b = int(np.argmax(cur))
        best_gain, best = 0.0, None
        for i in groups[b]:
            cand = np.maximum(loads_e + e[i], loads_l + l[i])
            cand[b] = np.inf
            j = int(np.argmin(cand))
            new_e, new_l = loads_e.copy(), loads_l.copy()
            new_e[b] -= e[i]; new_l[b] -= l[i]
            new_e[j] += e[i]; new_l[j] += l[i]
            val = float(np.max(np.maximum(new_e, new_l)))
            gain = float(cur.max()) - val
            if gain > best_gain + 1e-15:
                best_gain, best = gain, (i, j)
        if best is None:
            break
        i, j = best
        groups[b].remove(i)
        groups[j].append(i)
        loads_e[b] -= e[i]; loads_l[b] -= l[i]
        loads_e[j] += e[i]; loads_l[j] += l[i]
    return groups


def lpt_assign_batch(e_dur: np.ndarray, l_dur: np.ndarray, m: int
                     ) -> tuple:
    """Vectorized-over-trials LPT: partition each row independently.

    e_dur/l_dur: ``(T, n)`` per-item duration pairs for T independent
    instances (e.g. Monte-Carlo trials in
    `objective.BalancedQuantileObjective`).  Per row this computes exactly
    ``lpt_schedule(e, l, m, refine=False)`` — same sort, same greedy
    argmin tie-breaking — but the per-item step runs once over all T rows,
    which is what keeps the search objectives' re-rank fast at large GBS
    (the per-item Python loop was the bottleneck, not the simulator).

    Returns ``(assign, loads_e, loads_l)``: ``assign[t, i]`` is item i's
    bucket, and the ``(T, m)`` load matrices are the per-bucket duration
    sums (the LPT loop maintains them anyway — callers that only need
    bucket totals skip a second reduction).
    """
    e = np.asarray(e_dur, dtype=np.float64)
    l = np.asarray(l_dur, dtype=np.float64)
    if e.ndim != 2:
        raise ValueError(f"expected (T, n) durations, got shape {e.shape}")
    T, n = e.shape
    order = np.argsort(-np.maximum(e, l), axis=1)
    eo = np.take_along_axis(e, order, axis=1)         # durations in LPT order
    lo = np.take_along_axis(l, order, axis=1)
    rows = np.arange(T)
    loads_e = np.zeros((T, m))
    loads_l = np.zeros((T, m))
    assign = np.empty((T, n), dtype=np.int64)
    # The first min(m, n) items each open a fresh bucket: empty buckets tie
    # at max(e_i, l_i) and argmin breaks ties toward the lowest index, while
    # any non-empty bucket is strictly more expensive — so sorted item k
    # lands in bucket k.  One vectorized step instead of a third to half of
    # the sequential argmin passes.  The strictness argument needs every
    # LLM duration positive (a loaded bucket j could otherwise tie an
    # e-dominant item: l_j ≥ d_k by sort order forces l_k ≤ 0); durations
    # from `PerfModel` always are, but fall back to the plain loop if not.
    head = min(m, n)
    if head and not (lo[:, :head] > 0.0).all():
        head = 0
    loads_e[:, :head] = eo[:, :head]
    loads_l[:, :head] = lo[:, :head]
    np.put_along_axis(assign, order[:, :head],
                      np.broadcast_to(np.arange(head), (T, head)), axis=1)
    # sequential tail: one fused argmin step per item across all T rows
    cand_e = np.empty((T, m))
    cand_l = np.empty((T, m))
    flat_e, flat_l = loads_e.reshape(-1), loads_l.reshape(-1)
    for k in range(head, n):
        ei, li = eo[:, k], lo[:, k]
        np.add(loads_e, ei[:, None], out=cand_e)
        np.add(loads_l, li[:, None], out=cand_l)
        np.maximum(cand_e, cand_l, out=cand_e)
        j = np.argmin(cand_e, axis=1)
        flat = rows * m + j
        flat_e[flat] += ei
        flat_l[flat] += li
        assign[rows, order[:, k]] = j
    return assign, loads_e, loads_l


def cmax(e_dur, l_dur, groups) -> float:
    """Objective value (Eq. 6) of a partition."""
    e = np.asarray(e_dur, dtype=np.float64)
    l = np.asarray(l_dur, dtype=np.float64)
    worst = 0.0
    for g in groups:
        if g:
            worst = max(worst, e[g].sum(), l[g].sum())
    return worst


def lower_bound(e_dur, l_dur, m: int) -> float:
    """C_max ≥ max(mean load per bucket, largest single item)."""
    e = np.asarray(e_dur, dtype=np.float64)
    l = np.asarray(l_dur, dtype=np.float64)
    lb = max(e.sum() / m, l.sum() / m)
    if len(e):
        lb = max(lb, float(np.max(np.maximum(e, l))))
    return lb
