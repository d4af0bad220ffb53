"""Exact microbatch partitioning (paper §3.4.1) via branch-and-bound.

The paper formulates the partition as an ILP minimizing
    C_max = max_j max(E_j, L_j)
and solves it with a commercial solver under a strict time limit, falling
back to LPT on timeout.  We implement the same contract with an in-repo
depth-first branch-and-bound:

  * items processed in LPT order (largest first) — strong early incumbents;
  * incumbent initialized with the LPT solution, so the anytime result is
    never worse than the fallback;
  * pruning on  max(current C_max, remaining-load lower bound) ≥ incumbent;
  * bucket-symmetry breaking (an item may open at most one empty bucket);
  * deadline checks every node; on timeout returns the incumbent with
    optimal=False (the paper's "reverts to LPT" path, §3.4.2 / Fig. 16b).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler.lpt import cmax, lower_bound, lpt_schedule


@dataclass
class BnBResult:
    groups: List[List[int]]
    cmax: float
    optimal: bool
    nodes: int
    elapsed_s: float
    timed_out: bool


def solve_makespan_bnb(e_dur: Sequence[float], l_dur: Sequence[float], m: int,
                       *, time_limit_s: float = 0.25,
                       node_limit: int = 2_000_000,
                       max_exact_n: int = 768) -> BnBResult:
    t0 = time.monotonic()
    e = np.asarray(e_dur, dtype=np.float64)
    l = np.asarray(l_dur, dtype=np.float64)
    n = len(e)
    if n == 0 or m <= 0:
        return BnBResult([[] for _ in range(max(m, 0))], 0.0, True, 0, 0.0, False)
    if m == 1:
        return BnBResult([list(range(n))], max(e.sum(), l.sum()), True, 1,
                         time.monotonic() - t0, False)
    if n > max_exact_n:
        # very large instances: exact search is pointless within the budget
        # (and recursion-deep); go straight to the LPT fallback — the paper's
        # GBS-2048 regime, where LPT lands <1% from the lower bound.
        groups = lpt_schedule(e, l, m)
        val = cmax(e, l, groups)
        lb = lower_bound(e, l, m)
        return BnBResult(groups, val, val <= lb * (1 + 1e-9), 1,
                         time.monotonic() - t0, True)

    order = np.argsort(-(np.maximum(e, l)))
    e_s, l_s = e[order], l[order]
    # suffix sums for the load lower bound
    suf_e = np.concatenate([np.cumsum(e_s[::-1])[::-1], [0.0]])
    suf_l = np.concatenate([np.cumsum(l_s[::-1])[::-1], [0.0]])

    incumbent = lpt_schedule(e, l, m)
    best_val = cmax(e, l, incumbent)
    lb_global = lower_bound(e, l, m)
    if best_val <= lb_global * (1 + 1e-12):
        return BnBResult(incumbent, best_val, True, 1,
                         time.monotonic() - t0, False)

    assign = np.full(n, -1, dtype=np.int64)
    best_assign: Optional[np.ndarray] = None
    loads_e = np.zeros(m)
    loads_l = np.zeros(m)
    nodes = 0
    timed_out = False
    deadline = t0 + time_limit_s

    def dfs(i: int, used: int, cur_max: float):
        nonlocal best_val, best_assign, nodes, timed_out
        if timed_out:
            return
        nodes += 1
        if nodes % 1024 == 0 and (time.monotonic() > deadline
                                  or nodes > node_limit):
            timed_out = True
            return
        if i == n:
            if cur_max < best_val - 1e-12:
                best_val = cur_max
                best_assign = assign.copy()
            return
        # remaining-load bound: even perfectly balanced, the future load
        # plus current loads cannot beat this
        rem_bound = max(
            (loads_e.sum() + suf_e[i]) / m,
            (loads_l.sum() + suf_l[i]) / m,
        )
        if max(cur_max, rem_bound) >= best_val - 1e-12:
            return
        tried_empty = False
        # visit buckets in order of resulting bottleneck (best-first)
        cand = np.maximum(loads_e[:min(used + 1, m)] + e_s[i],
                          loads_l[:min(used + 1, m)] + l_s[i])
        for j in np.argsort(cand):
            j = int(j)
            empty = loads_e[j] == 0 and loads_l[j] == 0
            if empty:
                if tried_empty:
                    continue
                tried_empty = True
            new_max = max(cur_max, loads_e[j] + e_s[i], loads_l[j] + l_s[i])
            if new_max >= best_val - 1e-12:
                continue
            loads_e[j] += e_s[i]
            loads_l[j] += l_s[i]
            assign[i] = j
            dfs(i + 1, max(used, j + 1), new_max)
            loads_e[j] -= e_s[i]
            loads_l[j] -= l_s[i]
            assign[i] = -1
            if timed_out:
                return

    dfs(0, 0, 0.0)

    if best_assign is not None:
        groups: List[List[int]] = [[] for _ in range(m)]
        for sorted_i, bucket in enumerate(best_assign):
            groups[int(bucket)].append(int(order[sorted_i]))
        val = cmax(e, l, groups)
    else:
        groups, val = incumbent, best_val
    optimal = (not timed_out) or val <= lb_global * (1 + 1e-9)
    return BnBResult(groups, val, optimal, nodes,
                     time.monotonic() - t0, timed_out)
