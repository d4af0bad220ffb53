"""DFLOP façade: profile → plan → schedule (paper Fig. 3).

    engine = DFLOPEngine(enc_cfg, llm_cfg, cluster, tokens_per_media_item)
    engine.profile(dataset)                  # Profiling Engine (§3.2)
    plan = engine.plan(gbs)                  # Data-aware Optimizer (§3.3)
    sched = engine.scheduler()               # Online Scheduler (§3.4)
    for batch_items in loader:
        out = sched.schedule(batch_items)    # index groups -> data loader

The port prices with ``AnalyticBackend(H100)`` unless a backend is given.
The reference's closed loops, ``runtime()`` (observe → re-plan) and
``serving()``, need ``runtime/`` and ``serve/``, which the port does not
have yet: both raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch.common.types import ModelConfig
from repro_torch.core.optimizer.objective import Objective
from repro_torch.core.optimizer.search import ParallelismOptimizer, SearchResult
from repro_torch.core.optimizer.space import ClusterSpec, ParallelismPlan
from repro_torch.core.profiling.analytic import H100, AnalyticBackend, HardwareSpec
from repro_torch.core.profiling.data_profiler import DataProfiler, ShapeDistribution
from repro_torch.core.profiling.model_profiler import (
    Backend,
    ModelProfiler,
    PerfModel,
)
from repro_torch.core.scheduler.adaptive import AdaptiveCorrection
from repro_torch.core.scheduler.online import OnlineMicrobatchScheduler


@dataclass
class DFLOPEngine:
    llm_cfg: ModelConfig
    cluster: ClusterSpec
    tokens_per_media_item: int = 196
    enc_cfg: Optional[ModelConfig] = None
    e_seq_len: int = 729                 # encoder tokens per media item
    backend: Optional[Backend] = None
    mode: str = "train"
    # search objective: "mean" (Algorithm 1), "expected-random" (Monte-Carlo
    # over random assignment), "balanced-quantile" (heterogeneity-aware
    # LPT-balanced p90), or an `objective.Objective` *instance* — pass an
    # instance to pin non-default config (e.g. quantile) so background
    # re-plans score plans the same way the initial search did.
    objective: "str | Objective" = "mean"

    perf: Optional[PerfModel] = None
    dist: Optional[ShapeDistribution] = None
    plan_result: Optional[SearchResult] = None

    # ------------------------------------------------------------------ #
    def profile(self, dataset=None, items: Optional[Sequence] = None,
                n_samples: int = 2048) -> "DFLOPEngine":
        """Run Model Profiler + Data Profiler (they run concurrently in the
        paper; both are sub-minute here)."""
        backend = self.backend or AnalyticBackend(H100)
        tp_max = self.cluster.chips_per_node
        tps = [t for t in (1, 2, 4, 8, 16, 32) if t <= tp_max]
        profiler = ModelProfiler(backend, tp_degrees=tps, mode=self.mode)
        self.perf = profiler.profile_mllm(self.enc_cfg, self.llm_cfg,
                                          self.e_seq_len)
        dp = DataProfiler(self.tokens_per_media_item)
        if items is not None:
            self.dist = dp.profile(items)
        elif dataset is not None:
            self.dist = dp.profile_sampler(dataset, n_samples)
        else:
            self.dist = ShapeDistribution(np.ones(1), np.full(1, 1024.0))
        return self

    # ------------------------------------------------------------------ #
    def plan(self, gbs: int, **kw) -> SearchResult:
        """Run the optimizer.  kw forwards to `ParallelismOptimizer` —
        notably ``calibrator=`` (couple the search to runtime calibration),
        ``seed=`` (Monte-Carlo draw) and ``quantile=``/``n_trials=``.
        The resolved objective instance is pinned back onto
        ``self.objective`` so background re-plans (`runtime()`) score plans
        under the same configuration the initial search used."""
        assert self.perf is not None, "call profile() first"
        kw.setdefault("objective", self.objective)
        opt = ParallelismOptimizer(self.cluster, self.perf, mode=self.mode,
                                   **kw)
        self.objective = opt.objective_obj
        self.plan_result = opt.search(self.dist, gbs)
        return self.plan_result

    def baseline_plan(self, gbs: int, tp: int, pp: int) -> SearchResult:
        opt = ParallelismOptimizer(self.cluster, self.perf, mode=self.mode)
        return opt.baseline_uniform(self.dist, gbs, tp, pp)

    # ------------------------------------------------------------------ #
    def scheduler(self, plan: Optional[ParallelismPlan] = None,
                  adaptive: bool = True,
                  ilp_time_limit_s: float = 0.25) -> OnlineMicrobatchScheduler:
        plan = plan or (self.plan_result.plan if self.plan_result else None)
        assert plan is not None, "call plan() first or pass a plan"
        corr = AdaptiveCorrection() if adaptive else None
        return OnlineMicrobatchScheduler(
            plan, self.perf, self.tokens_per_media_item,
            ilp_time_limit_s=ilp_time_limit_s, adaptive=corr, mode=self.mode)

    # ------------------------------------------------------------------ #
    def runtime(self, gbs: int, **kw):
        raise NotImplementedError(
            "the closed control loop (runtime/, data/composer.py) is not "
            "ported yet")

    def serving(self, **kw):
        raise NotImplementedError(
            "the serving loop (serve/, runtime/) is not ported yet")
