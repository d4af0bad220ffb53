"""DFLOP façade: profile → plan → schedule (paper Fig. 3).

    engine = DFLOPEngine(enc_cfg, llm_cfg, cluster, tokens_per_media_item)
    engine.profile(dataset)                  # Profiling Engine (§3.2)
    plan = engine.plan(gbs)                  # Data-aware Optimizer (§3.3)
    sched = engine.scheduler()               # Online Scheduler (§3.4)
    for batch_items in loader:
        out = sched.schedule(batch_items)    # index groups -> data loader

Closed-loop operation (repro_torch.runtime) adds observe → re-plan on top:

    ctl = engine.runtime(gbs)                # RuntimeController
    for batch_items in loader:
        out = ctl.schedule(batch_items)      # drift-checked, hot-swappable
        ...run step, measure...
        ctl.observe_step(out, measured_s)    # telemetry + drift feedback

The port prices with ``AnalyticBackend(H100)`` unless a backend is given.
``serving(backend="real")`` runs the model through
``repro_torch.serve.real.RealBackend`` on the card unless ``devices`` says
otherwise.
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
    def runtime(self, gbs: int, *, plan: Optional[ParallelismPlan] = None,
                adaptive: bool = True, calibrate: bool = True,
                trace: bool = True, drift=None, auto_replan: bool = True,
                min_improvement: float = 0.02,
                replan_n_trials: int = 8,
                ilp_time_limit_s: float = 0.25,
                param_swapper=None,
                swap_horizon_batches: int = 50,
                compose_window: int = 0,
                max_staleness: Optional[int] = None,
                fleet=None):
        """Closed control loop: returns a `repro.runtime.RuntimeController`
        wrapping this engine + a fresh scheduler.  Plans first if needed.

        ``param_swapper`` (see `repro_torch.launch.reshard.ParamSwapper`) threads
        the training loop's *live* params through the controller: a plan
        hot-swap then physically re-lays-out parameters on device, gated on
        amortized reshard cost over ``swap_horizon_batches``.

        ``compose_window=W`` > 0 attaches a lookahead batch composer
        (`repro.data.composer.LookaheadComposer`) holding a ``W·gbs``
        reorder window; ``max_staleness`` bounds how many batches an item
        may wait in it (default ``2·W``).  The controller wires the
        composer's telemetry and flushes its window pricing on plan
        hot-swaps; feed it via ``ctl.compose(draw=...)`` or
        ``ScheduledLoader(composer=ctl.composer)``.

        ``fleet`` (see `repro_torch.launch.fleet.FleetManager`) makes the loop
        *elastic*: the controller drains membership events at batch
        boundaries (`poll_fleet`) and recovers checkpoint-free — re-plan
        for the surviving roster, migrate live params via
        ``param_swapper`` (use ``mesh_factory=fleet.plan_mesh``), degrade
        instead of crashing when either fails.

        ``trace``: record the controller's own trace, or the
        `TraceRecorder` to record it into (``train_mllm --trace`` hands it
        the process's recorder, ``common.trace.recorder()``)."""
        from repro_torch.runtime import (DriftDetector, OnlineCalibrator,
                                         RuntimeController, RuntimeMetrics,
                                         TraceRecorder)
        if plan is None:
            if self.plan_result is None or self.plan_result.plan is None:
                self.plan(gbs)
            plan = self.plan_result.plan
        sched = self.scheduler(plan=plan, adaptive=adaptive,
                               ilp_time_limit_s=ilp_time_limit_s)
        composer = None
        if compose_window > 0:
            from repro_torch.data.composer import LookaheadComposer
            composer = LookaheadComposer(sched, gbs=gbs,
                                         window=compose_window,
                                         max_staleness=max_staleness)
        return RuntimeController(
            self, sched, gbs,
            trace=(trace if isinstance(trace, TraceRecorder)
                   else TraceRecorder(enabled=trace)),
            metrics=RuntimeMetrics(),
            calibration=OnlineCalibrator() if calibrate else None,
            drift=drift if drift is not None else DriftDetector(),
            auto_replan=auto_replan, min_improvement=min_improvement,
            replan_n_trials=replan_n_trials,
            param_swapper=param_swapper,
            swap_horizon_batches=swap_horizon_batches,
            composer=composer,
            fleet=fleet)

    # ------------------------------------------------------------------ #
    def serving(self, *, admission: str = "slo", serve_cfg=None,
                calibrate: bool = True, trace: bool = True,
                drift=True, backend="emulated", model_params=None,
                model_cfg=None, max_len: int = 128, chunk: int = 16,
                devices=None, warmup: bool = True):
        """Serving-side closed loop: returns a `repro_torch.serve.ServeEngine`
        whose admission pricing runs through this engine's profiled
        `PerfModel` (``profile()`` first).  ``admission``: ``"slo"``
        (data-aware `SLOAdmission`) or ``"fifo"`` (baseline); the trace /
        metrics / calibrator / Page–Hinkley wiring mirrors ``runtime()``.

        ``backend`` selects the execution layer: ``"emulated"`` (the
        discrete-event model), ``"real"`` (prefill/decode on the model via
        `repro_torch.serve.real.RealBackend` — requires ``model_params``, and
        ``model_cfg`` when it differs from ``llm_cfg``; ``max_len`` /
        ``chunk`` / ``devices`` / ``warmup`` pass through), or an
        `ExecutionBackend` *factory* ``f(pricer, cfg) -> backend``.
        ``drift`` may be a bool or a ready `PageHinkley` (the real loop
        usually wants a shorter burn-in than the emulation's default).
        The real loop widens the calibrator's ratio clip: its "prefill"
        cells convert perf-model accelerator-seconds into measured host
        wall-seconds, a ratio far beyond the in-family default of 8×."""
        assert self.perf is not None, "call profile() first"
        from repro_torch.runtime import (OnlineCalibrator, RuntimeMetrics,
                                         TraceRecorder)
        from repro_torch.runtime.drift import PageHinkley
        from repro_torch.serve import (FIFOAdmission, PrefillPricer,
                                       ServeConfig, ServeEngine)
        cfg = serve_cfg if serve_cfg is not None else ServeConfig()
        if not calibrate:
            cal = None
        elif backend == "real":
            cal = OnlineCalibrator(max_ratio=1e9, min_obs=1)
        else:
            cal = OnlineCalibrator()
        pricer = PrefillPricer(self.perf, self.tokens_per_media_item,
                               tp=cfg.tp, calibrator=cal)
        if backend == "emulated":
            be = None                    # ServeEngine's EmulatedBackend
        elif backend == "real":
            assert model_params is not None, "real backend needs params"
            from repro_torch.serve.real import RealBackend
            be = RealBackend(model_cfg if model_cfg is not None
                             else self.llm_cfg, model_params, pricer, cfg,
                             max_len=max_len, chunk=chunk, devices=devices,
                             warmup=warmup)
        else:
            be = backend(pricer, cfg)
        ph = drift if isinstance(drift, PageHinkley) \
            else (PageHinkley() if drift else None)
        eng = ServeEngine(
            pricer, cfg, backend=be,
            admission=(FIFOAdmission() if admission == "fifo" else None),
            calibrator=cal,
            drift=ph,
            trace=TraceRecorder(enabled=trace,
                                process_name="dflop-serve"),
            metrics=RuntimeMetrics())
        return eng
