"""Data-aware 3D Parallelism Optimizer (paper §3.3, Algorithm 1).

Finds θ* = (E_tp, E_pp, E_dp, L_tp, L_pp, L_dp, N_mb, schedule) minimizing
the expected makespan subject to chip-count (Eq. 3) and memory (Eq. 4/5)
constraints, using the Profiling Engine's throughput/memory models and the
Data Profiler's shape statistics.  The schedule family (1F1B, interleaved
virtual stages, encoder-in-bubble — see ``docs/schedules.md``) is searched
*jointly* with the partition: each family reuses the same duration/memory
tables and only changes the closed-form step estimate.

Implementation note: Algorithm 1's inner loop evaluates shapes of the form
    t_seq = mean_seq · GBS / (i · L_dp)
whose value depends only on k = i · L_dp ∈ {1..GBS}.  We therefore
precompute duration and memory tables indexed by (tp[, pp], k) once and
evaluate every candidate configuration with vectorized lookups — this keeps
the optimizer sub-second at 1024 chips (Fig. 16a) while remaining exactly
Algorithm 1.  Complexity matches the paper: O(GBS · N_chips^(1+ε)).

The scoring rule is pluggable (`repro.core.optimizer.objective`): the
vectorized mean-shape pass is always the prefilter; for a sampling
objective (``expected-random``, ``balanced-quantile``) the top candidates
are re-ranked — including alternative N_mb, since heterogeneity-aware
scores systematically prefer *fewer* buckets than the mean-shape estimate.
A `DurationCorrector` (e.g. the runtime's `OnlineCalibrator`) refines both
the tables and the Monte-Carlo durations, so the search sees the same
corrected durations the Online Scheduler trusts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.optimizer.makespan import mean_makespan
from repro_torch.core.optimizer.objective import (
    DurationCorrector,
    Objective,
    correct_durations,
    get_objective,
)
from repro_torch.core.optimizer.space import (
    SCHEDULES,
    VIRTUAL_CHUNKS,
    ClusterSpec,
    ModuleParallelism,
    ParallelismPlan,
    enumerate_configs,
)
from repro_torch.core.profiling.data_profiler import ShapeDistribution
from repro_torch.core.profiling.model_profiler import ModulePerf, PerfModel


def _pow2s_up_to(n: int):
    v, out = 1, []
    while v <= n:
        out.append(v)
        v *= 2
    return out


class _ModuleTables:
    """Vectorized duration/memory tables for one module.

    dur[tp][k]          — stage duration for shape(k) on one TP group
    model_state[tp][pp] — Eq.4/5 model-state bytes
    act[tp][pp][k]      — activation bytes for shape(k)
    where shape(k) = mean_shape · GBS / k.

    With a `corrector`, every duration entry is refined at its own shape —
    the per-(module, shape-bucket, tp) path the Online Scheduler applies to
    its predictions, so search-time and schedule-time durations agree.
    """

    def __init__(self, perf: ModulePerf, mean_shape: float, gbs: int,
                 tps, pps, mode: str, is_encoder: bool, *,
                 corrector: Optional[DurationCorrector] = None):
        self.gbs = gbs
        self.module = "encoder" if is_encoder else "llm"
        ks = np.arange(1, gbs + 1, dtype=np.float64)
        shapes = mean_shape * gbs / ks                     # shape(k)
        self.shapes = shapes
        n_layers = perf.cfg.n_layers

        # the same vectorized attn/lin-polynomial duration path the
        # scheduler's per-item predictions use (ModulePerf.duration_batch).
        # Corrections key on shape(k); aggregate sizes the per-item
        # calibration never observed fall back to the mean item shape's
        # cell (see OnlineCalibrator.correct) so a uniform runtime
        # slowdown reaches every table entry, not just item-scale ones.
        self.dur: Dict[int, np.ndarray] = {}
        for tp in tps:
            dur = perf.duration_batch(shapes, tp, mode)
            self.dur[tp] = correct_durations(corrector, self.module, shapes,
                                             tp, dur,
                                             fallback_shape=mean_shape)

        self.model_state: Dict[Tuple[int, int], float] = {}
        self.act: Dict[Tuple[int, int], np.ndarray] = {}
        for tp in tps:
            for pp in pps:
                layers = n_layers / pp
                self.model_state[(tp, pp)] = perf.memory.model_state(layers, tp)
                pts = np.stack([np.full_like(shapes, layers),
                                np.full_like(shapes, tp), shapes], axis=1)
                self.act[(tp, pp)] = perf.memory.act_state_grid.batch(pts)


@dataclass
class SearchResult:
    plan: Optional[ParallelismPlan]
    makespan: float
    n_configs: int
    n_feasible: int
    elapsed_s: float
    history: list = field(default_factory=list)

    @property
    def found(self) -> bool:
        return self.plan is not None


class ParallelismOptimizer:
    def __init__(self, cluster: ClusterSpec, perf: PerfModel, *,
                 max_pp: Optional[int] = None, mode: str = "train",
                 objective: str | Objective = "mean",
                 n_trials: Optional[int] = None,
                 quantile: Optional[float] = None, seed: int = 0,
                 calibrator: Optional[DurationCorrector] = None,
                 partition_step: int = 0, keep_history: bool = False,
                 refine_expected_top_k: int = 32,
                 schedules: Sequence[str] = SCHEDULES):
        """objective: 'mean' (Algorithm 1), 'expected-random' (Eq. 1 via
        Monte-Carlo over random round-robin assignment), 'balanced-quantile'
        (LPT-balanced assignment scored at `quantile`), or any
        `objective.Objective` instance.  Sampling objectives use the
        mean-based prefilter, then re-rank the top candidates.
        n_trials/quantile default to the objective's own configuration
        (None = leave untouched; for an instance a provided value yields a
        reconfigured copy).

        seed: base seed for the Monte-Carlo draws — equal seeds reproduce
        the search exactly, distinct seeds resample the trial batches.
        calibrator: optional `DurationCorrector` refining every duration
        the search evaluates (tables and Monte-Carlo alike).
        schedules: schedule families to enumerate (default: all of
        `space.SCHEDULES`); pass ("1f1b",) to reproduce the fixed-schedule
        search the paper's Algorithm 1 describes."""
        self.cluster = cluster
        self.perf = perf
        self.mode = mode
        self.objective_obj = get_objective(objective, n_trials=n_trials,
                                           q=quantile)
        self.objective = self.objective_obj.name
        self.n_trials = getattr(self.objective_obj, "n_trials", n_trials)
        self.seed = seed
        self.calibrator = calibrator
        self.schedules = tuple(schedules)
        self.keep_history = keep_history
        self.refine_top_k = refine_expected_top_k
        self.max_pp = max_pp if max_pp is not None else \
            min(64, perf.llm.cfg.n_layers)
        if partition_step:
            self.partition_step = partition_step
        else:
            self.partition_step = max(1, cluster.n_chips // 256)

    # ------------------------------------------------------------------ #
    def _divisor_pps(self, n_layers_cap: int):
        return list(range(1, min(self.max_pp, n_layers_cap) + 1))

    def build_tables(self, dist: ShapeDistribution, gbs: int
                     ) -> Tuple[_ModuleTables, Optional[_ModuleTables]]:
        """(llm_tables, encoder_tables) for `search()` — public so tests can
        assert the calibrator-refined durations match the scheduler's."""
        perf, cluster = self.perf, self.cluster
        mean_bsz, mean_seq = dist.mean() if len(dist) else (1.0, 1.0)
        tps = _pow2s_up_to(cluster.chips_per_node)
        l_pps = self._divisor_pps(perf.llm.cfg.n_layers)
        l_tab = _ModuleTables(perf.llm, mean_seq, gbs, tps, l_pps,
                              self.mode, is_encoder=False,
                              corrector=self.calibrator)
        e_tab = None
        if perf.encoder is not None:
            e_pps = self._divisor_pps(perf.encoder.cfg.n_layers)
            e_tab = _ModuleTables(perf.encoder, mean_bsz, gbs, tps, e_pps,
                                  self.mode, is_encoder=True,
                                  corrector=self.calibrator)
        return l_tab, e_tab

    @staticmethod
    def _k_index(tab: _ModuleTables, mp: ModuleParallelism, gbs: int,
                 n_max: int):
        """(dur, act) table rows at k = min(i·dp, gbs) − 1 for i = 1..n_max.
        The common case (i·dp ≤ gbs throughout) is a dp-strided *view* —
        this lookup runs once per enumerated config, so avoiding the fancy
        copy is what keeps the prefilter sub-second at 1024 chips."""
        if mp.dp * n_max <= gbs:
            sl = slice(mp.dp - 1, mp.dp * n_max, mp.dp)
            return tab.dur[mp.tp][sl], tab.act[(mp.tp, mp.pp)][sl]
        k = np.minimum(np.arange(1, n_max + 1) * mp.dp, gbs) - 1
        return tab.dur[mp.tp][k], tab.act[(mp.tp, mp.pp)][k]

    def _eval_config(self, ep: Optional[ModuleParallelism],
                     lp: ModuleParallelism, sched: str, gbs: int,
                     l_tab: _ModuleTables, e_tab: Optional[_ModuleTables]):
        """Mean-shape makespan + feasibility for every N_mb of one
        (config, schedule-family) pair.  Returns (i, T, feas) arrays with
        infeasible or family-invalid N_mb (interleaved divisibility) scored
        inf, or None when no N_mb fits in memory (short-circuits before the
        makespan math — the search hot path).  Candidate validity is
        `np.isfinite(T)`, which is `feas` *and* the family constraint."""
        mem_cap = self.cluster.mem_bytes
        n_max = max(1, gbs // lp.dp)
        l_dur, l_act = self._k_index(l_tab, lp, gbs, n_max)
        l_mem = l_tab.model_state[(lp.tp, lp.pp)] + lp.pp * l_act
        i = np.arange(1, n_max + 1)
        if sched == "encoder_fill":
            # the replicated encoder shares the LLM's chips, so the memory
            # budgets add; its act window matches the LLM's in-flight depth.
            e_dur, e_act = self._k_index(e_tab, ep, gbs, n_max)
            feas = (l_mem + e_tab.model_state[(ep.tp, 1)]
                    + lp.pp * e_act <= mem_cap)
            if not feas.any():
                return None
            # per-slot cost is *serial* LLM stage + encoder chunk (the
            # conservative closed form — `schedule_makespan` convention).
            T = (i + lp.pp - 1) * (l_dur + e_dur) / lp.pp
            T[~feas] = np.inf
            return i, T, feas
        feas = l_mem <= mem_cap
        if ep is not None:
            e_dur, e_act = self._k_index(e_tab, ep, gbs, n_max)
            feas &= (e_tab.model_state[(ep.tp, ep.pp)]
                     + (ep.pp + lp.pp) * e_act <= mem_cap)
        if not feas.any():
            return None
        if ep is not None:
            dur = np.maximum(e_dur / ep.pp, l_dur / lp.pp)
            e_pp = ep.pp
        else:
            dur = l_dur / lp.pp
            e_pp = 0
        depth = e_pp + lp.pp
        if sched == "interleaved":
            T = (i + (depth - 1) / VIRTUAL_CHUNKS) * dur
            T[i % depth != 0] = np.inf       # family divisibility constraint
        else:
            T = (i + depth - 1) * dur
        T[~feas] = np.inf
        return i, T, feas

    def search(self, dist: ShapeDistribution, gbs: int) -> SearchResult:
        t0 = time.monotonic()
        perf, cluster = self.perf, self.cluster
        has_encoder = perf.encoder is not None
        l_tab, e_tab = self.build_tables(dist, gbs)

        best_T = float("inf")
        best: Optional[ParallelismPlan] = None
        n_configs = n_feasible = 0
        history = []
        rerank = self.objective != "mean" and len(dist) > 0
        top: list = []       # (T_mean, ep, lp, sched) candidates to re-rank

        for ep, lp, sched in enumerate_configs(
                cluster, has_encoder=has_encoder, max_pp=self.max_pp,
                partition_step=self.partition_step,
                schedules=self.schedules):
            if lp.pp > perf.llm.cfg.n_layers:
                continue
            if ep is not None and ep.pp > perf.encoder.cfg.n_layers:
                continue
            if sched == "interleaved" and (
                    lp.pp * VIRTUAL_CHUNKS > perf.llm.cfg.n_layers
                    or (ep is not None
                        and ep.pp * VIRTUAL_CHUNKS > perf.encoder.cfg.n_layers)):
                continue      # each rank hosts v chunks: needs pp·v layers
            n_configs += 1
            evald = self._eval_config(ep, lp, sched, gbs, l_tab, e_tab)
            if evald is None:
                continue
            i, T, feas = evald
            n_feasible += int(feas.sum())
            j = int(np.argmin(T))
            if not np.isfinite(T[j]):
                continue      # feasible N_mb exist but none family-valid
            if self.keep_history:
                plan_j = ParallelismPlan(llm=lp, encoder=ep, n_mb=int(i[j]),
                                         schedule=sched)
                history.append((plan_j.as_tuple(), float(T[j])))
            if T[j] < best_T:
                best_T = float(T[j])
                best = ParallelismPlan(llm=lp, encoder=ep, n_mb=int(i[j]),
                                       schedule=sched)
            if rerank:
                top.append((float(T[j]), ep, lp, sched))

        if rerank and top:
            best, best_T = self._rerank(top, dist, gbs, l_tab, e_tab,
                                        fallback=(best, best_T))

        return SearchResult(best, best_T, n_configs, n_feasible,
                            time.monotonic() - t0, history)

    def _rerank(self, top: list, dist: ShapeDistribution, gbs: int,
                l_tab: _ModuleTables, e_tab: Optional[_ModuleTables],
                fallback):
        """Re-score the best mean-prefiltered configs under the sampling
        objective.  Each config is expanded over alternative feasible N_mb
        (powers of two plus the mean pick): the mean-shape estimate
        systematically overrates many-bucket plans under fat-tailed shape
        distributions, so the objective must be free to choose fewer."""
        top.sort(key=lambda t: t[0])
        plans = []
        for _, ep, lp, sched in top[: self.refine_top_k]:
            evald = self._eval_config(ep, lp, sched, gbs, l_tab, e_tab)
            if evald is None:
                continue
            i, _T, _feas = evald
            ok = np.isfinite(_T)      # feasible AND family-valid N_mb
            if not ok.any():
                continue
            cands = {int(i[int(np.argmin(_T))])}
            cands.update(v for v in _pow2s_up_to(int(i[-1])) if ok[v - 1])
            plans.extend(ParallelismPlan(llm=lp, encoder=ep, n_mb=n_mb,
                                         schedule=sched)
                         for n_mb in sorted(cands) if ok[n_mb - 1])
        if not plans:
            return fallback
        # the cache carries per-(tp, pp) item durations AND the sampled
        # trial indices, both plan-independent, across every candidate —
        # each plan evaluation is then one batched partition + one
        # schedule-family wavefront over all (trial, rank) instances.
        obj = self.objective_obj
        best, best_T = None, float("inf")
        dur_cache: Dict = {}
        for plan in plans:
            T = obj.evaluate(self.perf, plan, dist, gbs, mode=self.mode,
                             corrector=self.calibrator, seed=self.seed,
                             cache=dur_cache)
            if T < best_T:
                best_T, best = T, plan
        return (best, best_T) if best is not None else fallback

    # ------------------------------------------------------------------ #
    def baseline_uniform(self, dist: ShapeDistribution, gbs: int,
                         tp: int, pp: int) -> SearchResult:
        """Data-agnostic baseline: one uniform (tp, pp, dp) over the whole
        model (what Megatron/PyTorch enforce), maximal N_mb — the Fig. 7/10
        comparison point.  The encoder occupies pipeline stage 0 (Fig. 1)."""
        t0 = time.monotonic()
        N = self.cluster.n_chips
        if N % (tp * pp):
            return SearchResult(None, float("inf"), 0, 0, 0.0)
        dp = N // (tp * pp)
        mean_bsz, mean_seq = dist.mean() if len(dist) else (1.0, 1.0)
        n_mb = max(1, gbs // dp)
        from repro_torch.core.optimizer import memory_model as _mm

        def _mem_ok(ep, lp):
            t_bsz = mean_bsz * gbs / (n_mb * dp)
            t_seq = mean_seq * gbs / (n_mb * dp)
            return _mm.feasible(self.perf.encoder, self.perf.llm, ep, lp,
                                t_bsz, t_seq, self.cluster.mem_bytes)

        if self.perf.encoder is None:
            lp = ModuleParallelism(tp, pp, dp)
            plan = ParallelismPlan(llm=lp, encoder=None, n_mb=n_mb)
            if not _mem_ok(None, lp):
                return SearchResult(plan, float("inf"), 1, 0,
                                    time.monotonic() - t0)
            T = mean_makespan(self.perf, plan, mean_bsz, mean_seq, gbs,
                              self.mode)
            return SearchResult(plan, T, 1, 1, time.monotonic() - t0)
        if pp >= 2:
            # Fig. 1 layout: encoder = stage 0 (tp·dp chips), LLM = the
            # remaining pp−1 stages.  Total chips = tp·pp·dp = N exactly.
            ep = ModuleParallelism(tp, 1, dp)
            lp = ModuleParallelism(tp, pp - 1, dp)
            plan = ParallelismPlan(llm=lp, encoder=ep, n_mb=n_mb)
            if not _mem_ok(ep, lp):
                return SearchResult(plan, float("inf"), 1, 0,
                                    time.monotonic() - t0)
            T = mean_makespan(self.perf, plan, mean_bsz, mean_seq, gbs,
                              self.mode)
        else:
            # pp == 1: encoder and LLM colocated, executed sequentially.
            ep = ModuleParallelism(tp, 1, dp)
            lp = ModuleParallelism(tp, 1, dp)
            plan = ParallelismPlan(llm=lp, encoder=ep, n_mb=n_mb)
            if not _mem_ok(ep, lp):
                return SearchResult(plan, float("inf"), 1, 0,
                                    time.monotonic() - t0)
            from repro_torch.core.optimizer.makespan import stage_durations
            t_bsz = mean_bsz * gbs / (n_mb * dp)
            t_seq = mean_seq * gbs / (n_mb * dp)
            e_dur, l_dur = stage_durations(self.perf, ep, lp, t_bsz, t_seq,
                                           self.mode)
            T = n_mb * (e_dur + l_dur)
        return SearchResult(plan, T, 1, 1, time.monotonic() - t0)
