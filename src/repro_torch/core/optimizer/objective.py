"""Pluggable search objectives for the Parallelism Optimizer (paper Eq. 1).

Eq. 1 ranks plans by E_D[T(d; θ)] — an expectation over the *data-induced*
variation in computation.  Three interchangeable estimators of that
expectation live here:

  * ``mean``              — Algorithm 1's mean-shape approximation: one
                            aggregate shape per bucket, closed form.  Fast
                            (it is the vectorized prefilter in ``search()``)
                            but blind to heterogeneity: with ~1 item per
                            bucket under a fat-tailed shape distribution it
                            underestimates the bottleneck bucket badly.
  * ``expected-random``   — Monte-Carlo over sampled global batches with the
                            *data-agnostic* round-robin assignment real
                            loaders perform (``schedule_random``), scored by
                            the mean over trials.  Pessimistic: the Online
                            Scheduler will do better than random.
  * ``balanced-quantile`` — models what the Online Scheduler actually does:
                            sample global batches from the empirical
                            `ShapeDistribution`, partition each into the
                            plan's N_mb · L_dp buckets with ``lpt_schedule``
                            (optionally the hybrid BnB solver), and score
                            the plan by a configurable quantile (default
                            p90) of the per-trial pipeline makespans.

All three share one duration model — *per-item* stage durations summed per
bucket, exactly what the scheduler's ``cmax`` computes — and one correction
hook: a ``DurationCorrector`` (duck-typed to `OnlineCalibrator`) refines
every predicted duration, so the optimizer ranks plans with the same
corrected durations the scheduler trusts at runtime.

Sampling is seeded per trial with ``default_rng([seed, trial, ...])`` so
two objectives given the same seed see the *same* sampled batches (the
property tests rely on this), and so ``search(seed=…)`` can perturb the
Monte-Carlo draw without re-seeding global state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Protocol, Tuple

import numpy as np

from repro_torch.core.optimizer.makespan import (
    accepts_fallback,
    correct_scalar,
    mean_makespan,
    pipeline_makespan,  # noqa: F401  (re-exported for the property harness)
    schedule_makespan,
)
from repro_torch.core.optimizer.space import ParallelismPlan
from repro_torch.core.profiling.data_profiler import ShapeDistribution
from repro_torch.core.profiling.model_profiler import PerfModel

# NOTE: repro.core.scheduler imports this module (the scheduler shares the
# corrected-duration path), so scheduler solvers are imported lazily at
# call time to keep the package import acyclic.


class DurationCorrector(Protocol):
    """Multiplicative refinement of a predicted duration, keyed by
    (module, shape, tp) — `repro.runtime.calibration.OnlineCalibrator` is
    the canonical implementation."""

    def correct(self, module: str, shape: float, tp: int,
                predicted: float) -> float: ...


def correct_durations(corrector, module: str, shapes: np.ndarray, tp: int,
                      durs: np.ndarray,
                      fallback_shape: Optional[float] = None) -> np.ndarray:
    """Vectorized corrector application with a scalar fallback.

    fallback_shape: forwarded to correctors that support it (see
    `OnlineCalibrator.correct`) — used by the mean-shape search tables,
    whose aggregate bucket sizes the per-item calibration never observed.
    Correctors with the plain 4-argument protocol simply don't get it."""
    if corrector is None:
        return durs
    fn = getattr(corrector, "correct_array", None)
    if fn is not None:
        if fallback_shape is not None and accepts_fallback(fn):
            return fn(module, shapes, tp, durs,
                      fallback_shape=fallback_shape)
        return fn(module, shapes, tp, durs)
    return np.array([correct_scalar(corrector, module, float(s), tp,
                                    float(d), fallback_shape)
                     for s, d in zip(shapes, durs)])


def corrected_item_durations(perf: PerfModel, plan: ParallelismPlan,
                             enc_batches: np.ndarray, llm_seqs: np.ndarray,
                             *, mode: str = "train", adaptive=None,
                             corrector: Optional[DurationCorrector] = None,
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-item (E_dur, L_dur) under plan θ, refined by the correction
    hooks in scheduler order (adaptive first, then calibration).

    This is the single duration path shared by
    `OnlineMicrobatchScheduler.item_durations` and the sampling objectives,
    so the optimizer's Monte-Carlo sees byte-identical durations to the
    scheduler's predictions on identical shapes.
    """
    ep, lp = plan.encoder, plan.llm
    enc_batches = np.asarray(enc_batches, dtype=np.float64)
    llm_seqs = np.asarray(llm_seqs, dtype=np.float64)
    has_enc = perf.encoder is not None and ep is not None
    if has_enc:
        e_dur = perf.e_dur_batch(enc_batches, ep.tp, mode) / max(ep.pp, 1)
    else:
        e_dur = np.zeros(len(llm_seqs))
    l_dur = perf.l_dur_batch(llm_seqs, lp.tp, mode) / max(lp.pp, 1)
    if adaptive is not None:
        for i in range(len(llm_seqs)):
            if e_dur[i] > 0:
                e_dur[i] = adaptive.correct("encoder", float(enc_batches[i]),
                                            e_dur[i])
            l_dur[i] = adaptive.correct("llm", float(llm_seqs[i]), l_dur[i])
    if corrector is not None:
        if has_enc:
            e_dur = correct_durations(corrector, "encoder", enc_batches,
                                      ep.tp, e_dur)
        l_dur = correct_durations(corrector, "llm", llm_seqs, lp.tp, l_dur)
    return e_dur, l_dur


@dataclass
class ObjectiveResult:
    score: float
    samples: np.ndarray          # per-trial pipeline makespans


# Cache key for per-item duration arrays: durations depend only on the
# module parallelisms, not on n_mb, so a re-rank over many (plan, n_mb)
# candidates reuses them.
def _dur_key(plan: ParallelismPlan):
    ep = plan.encoder
    return ((ep.tp, ep.pp) if ep is not None else None,
            (plan.llm.tp, plan.llm.pp))


class Objective:
    """A plan-scoring rule. Lower is better."""

    name: str = "base"

    def evaluate(self, perf: PerfModel, plan: ParallelismPlan,
                 dist: ShapeDistribution, gbs: int, *, mode: str = "train",
                 corrector: Optional[DurationCorrector] = None,
                 seed: int = 0, cache: Optional[Dict] = None) -> float:
        return self.evaluate_samples(perf, plan, dist, gbs, mode=mode,
                                     corrector=corrector, seed=seed,
                                     cache=cache).score

    def evaluate_samples(self, perf, plan, dist, gbs, *, mode="train",
                         corrector=None, seed: int = 0,
                         cache=None) -> ObjectiveResult:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    def _item_durations(self, perf, plan, dist, mode, corrector, cache):
        key = _dur_key(plan)
        if cache is not None and key in cache:
            return cache[key]
        out = corrected_item_durations(perf, plan, dist.enc_batches,
                                       dist.llm_seqs, mode=mode,
                                       corrector=corrector)
        if cache is not None:
            cache[key] = out
        return out


class MeanObjective(Objective):
    """Algorithm 1: one mean shape per bucket, closed form (no sampling)."""

    name = "mean"

    def evaluate_samples(self, perf, plan, dist, gbs, *, mode="train",
                         corrector=None, seed: int = 0,
                         cache=None) -> ObjectiveResult:
        mean_bsz, mean_seq = dist.mean() if len(dist) else (1.0, 1.0)
        T = mean_makespan(perf, plan, mean_bsz, mean_seq, gbs, mode,
                          corrector=corrector)
        return ObjectiveResult(T, np.array([T]))


class _SamplingObjective(Objective):
    """Shared Monte-Carlo kernel: sample `n_trials` global batches from the
    empirical distribution, partition each into m = N_mb · L_dp buckets,
    and score the per-trial step.

    score:
      * ``"simulate"`` (default) — hand each rank's buckets to the
        event-driven 1F1B simulator (buckets map to (mb, rank) slots the
        way the data loader consumes `ScheduleOutput.groups`: bucket
        i·L_dp + r is microbatch i of rank r) and take the slowest rank.
        This anchors the objective to the 1F1B simulator: the closed
        formula charges the fattest bucket to *every* pipeline slot, which
        badly misprices fat-tailed batches where only one microbatch is
        fat.  All trials and ranks run in one `simulate_1f1b_batch`
        wavefront call, so this holds at every GBS — there is no
        large-GBS fallback to the closed form, and scores at different
        GBS are always produced by the same estimator.
      * ``"pipeline"`` — the paper's closed form
        (N_mb + depth − 1) · C_max, i.e. exactly the scheduler's
        `ScheduleOutput.step_makespan`.  Monotone in C_max, which makes the
        partition-dominance invariants provable — the property harness
        uses this mode.
    """

    def __init__(self, n_trials: int = 16, score: str = "simulate",
                 bwd_over_fwd: float = 2.0):
        self.n_trials = n_trials
        self.score = score
        self.bwd_over_fwd = bwd_over_fwd
        self._validate()

    def _validate(self) -> None:
        """Configuration invariants — re-checked by `get_objective` after
        reconfiguring a copy, so setattr can't smuggle in invalid values."""
        if self.score not in ("simulate", "pipeline"):
            raise ValueError(f"score must be 'simulate' or 'pipeline', "
                             f"got {self.score!r}")
        if self.n_trials < 1:
            raise ValueError(f"n_trials must be >= 1, got {self.n_trials}")

    def _partition(self, e: np.ndarray, l: np.ndarray, m: int, rng):
        """Return m index groups over one sampled batch (per-trial path)."""
        raise NotImplementedError

    def _partition_loads(self, e_s: np.ndarray, l_s: np.ndarray, m: int,
                         seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """(T, gbs) sampled per-item durations → (T, m) per-bucket sums.

        Default: loop `_partition` per trial (exact solvers and custom
        subclasses).  The LPT and round-robin partitioners override this
        with fully vectorized versions — the per-item Python loop, not the
        simulator, is what made large-GBS re-ranks slow."""
        T = e_s.shape[0]
        e_b = np.zeros((T, m))
        l_b = np.zeros((T, m))
        for t in range(T):
            rng_p = np.random.default_rng([seed, t, 1])
            for j, g in enumerate(self._partition(e_s[t], l_s[t], m, rng_p)):
                if len(g):
                    e_b[t, j] = e_s[t][g].sum()
                    l_b[t, j] = l_s[t][g].sum()
        return e_b, l_b

    def _aggregate(self, samples: np.ndarray) -> float:
        raise NotImplementedError

    # ------------------------------------------------------------------ #
    def _score_trials(self, plan: ParallelismPlan, e_b: np.ndarray,
                      l_b: np.ndarray, mode: str,
                      score: Optional[str] = None) -> np.ndarray:
        """(T, m) bucket-duration matrices → (T,) step makespans."""
        score = score or self.score
        e_pp = plan.encoder.pp if plan.encoder else 0
        if score == "pipeline":
            # bottleneck bucket priced by the plan's schedule family: the
            # staged families pay max(E, L) per slot, encoder_fill pays the
            # serial chunk+LLM sum (schedule_makespan does the /L_pp split)
            if plan.schedule == "encoder_fill":
                c = (l_b + e_b / plan.llm.pp).max(axis=-1)
                return (plan.n_mb + plan.bubble_slots) * c
            c = np.maximum(e_b, l_b).max(axis=-1)
            return schedule_makespan(plan, c, c)
        from repro_torch.core.pipeline.simulator import simulate_bucket_ranks_batch
        batch = simulate_bucket_ranks_batch(
            e_b, l_b, n_mb=plan.n_mb, dp=plan.llm.dp, e_pp=e_pp,
            l_pp=plan.llm.pp, bwd_over_fwd=self.bwd_over_fwd,
            backward=(mode == "train"), schedule=plan.schedule)
        return batch.makespan.max(axis=-1)       # slowest dp rank per trial

    def trial_makespan(self, plan: ParallelismPlan, groups,
                       e: np.ndarray, l: np.ndarray,
                       mode: str = "train", score: Optional[str] = None) -> float:
        """Step makespan of one partitioned batch — the standalone entry
        point (`evaluate_samples` scores whole trial batches at once via
        `_score_trials`)."""
        e_b = np.array([e[g].sum() if len(g) else 0.0 for g in groups])
        l_b = np.array([l[g].sum() if len(g) else 0.0 for g in groups])
        return float(self._score_trials(plan, e_b[None], l_b[None], mode,
                                        score)[0])

    def _sample_indices(self, n: int, gbs: int, seed: int,
                        cache: Optional[Dict]) -> np.ndarray:
        """(T, gbs) item indices; per-trial streams so objectives sharing
        `seed` sample identical batches regardless of how many draws their
        partitioners use.  Plan-independent, hence shared across a whole
        re-rank through `cache`."""
        key = ("idx", n, gbs, seed, self.n_trials)
        if cache is not None and key in cache:
            return cache[key]
        idx = np.stack([np.random.default_rng([seed, t]).integers(
            0, n, size=gbs) for t in range(self.n_trials)])
        if cache is not None:
            cache[key] = idx
        return idx

    def evaluate_samples(self, perf, plan, dist, gbs, *, mode="train",
                         corrector=None, seed: int = 0,
                         cache=None) -> ObjectiveResult:
        n = len(dist)
        if n == 0:
            mean_bsz, mean_seq = 1.0, 1.0
            T = mean_makespan(perf, plan, mean_bsz, mean_seq, gbs, mode,
                              corrector=corrector)
            return ObjectiveResult(T, np.array([T]))
        e_it, l_it = self._item_durations(perf, plan, dist, mode, corrector,
                                          cache)
        m = plan.n_buckets
        idx = self._sample_indices(n, gbs, seed, cache)
        e_s, l_s = e_it[idx], l_it[idx]
        e_b, l_b = self._partition_loads(e_s, l_s, m, seed)
        samples = self._score_trials(plan, e_b, l_b, mode)
        return ObjectiveResult(self._aggregate(samples), samples)


class ExpectedRandomObjective(_SamplingObjective):
    """Eq. 1 with the data-agnostic baseline assignment: a random
    permutation dealt round-robin into the buckets (exactly what
    ``OnlineMicrobatchScheduler.schedule_random`` and stock PyTorch /
    Megatron loaders do), scored by the mean over trials."""

    name = "expected-random"

    def _partition(self, e, l, m, rng):
        gbs = len(e)
        buckets = np.empty(gbs, dtype=np.int64)
        buckets[rng.permutation(gbs)] = np.arange(gbs) % m
        groups = [[] for _ in range(m)]
        for i, b in enumerate(buckets):
            groups[int(b)].append(i)
        return groups

    def _partition_loads(self, e_s, l_s, m, seed):
        # same rng stream as `_partition` (one permutation per trial), but
        # bucket sums land via one bincount over all trials
        T, gbs = e_s.shape
        buckets = np.empty((T, gbs), dtype=np.int64)
        deal = np.arange(gbs) % m
        for t in range(T):
            rng = np.random.default_rng([seed, t, 1])
            buckets[t, rng.permutation(gbs)] = deal
        flat = (np.arange(T)[:, None] * m + buckets).ravel()
        e_b = np.bincount(flat, weights=e_s.ravel(),
                          minlength=T * m).reshape(T, m)
        l_b = np.bincount(flat, weights=l_s.ravel(),
                          minlength=T * m).reshape(T, m)
        return e_b, l_b

    def _aggregate(self, samples: np.ndarray) -> float:
        return float(samples.mean())


class BalancedQuantileObjective(_SamplingObjective):
    """Heterogeneity-aware objective: partition each sampled batch the way
    the Online Scheduler will (`lpt_schedule`; ``solver='hybrid'`` uses the
    scheduler's exact-then-LPT BnB) and score by the q-quantile of the
    per-trial step makespans.  The quantile — not the mean — is what
    makes re-plan decisions sharp at small GBS: with ~1 item per bucket a
    fat tail lands in *some* bucket almost every batch, and p90 prices
    that in where the mean-shape estimate cannot."""

    name = "balanced-quantile"

    # NOTE on determinism: with the default solver='lpt', equal seeds
    # reproduce scores bit-for-bit.  solver='hybrid' partitions with the
    # wall-clock-limited BnB, which is only deterministic when the
    # instance is small enough to be solved to optimality within
    # `time_limit_s` (the property harness uses tiny instances with a
    # generous limit for exactly that reason).

    def __init__(self, n_trials: int = 16, q: float = 0.9,
                 solver: str = "lpt", refine: bool = False,
                 time_limit_s: float = 0.05, score: str = "simulate",
                 bwd_over_fwd: float = 2.0):
        self.q = q
        self.solver = solver
        self.refine = refine
        self.time_limit_s = time_limit_s
        super().__init__(n_trials, score, bwd_over_fwd)

    def _validate(self) -> None:
        super()._validate()
        if not 0.0 <= self.q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {self.q}")
        if self.solver not in ("lpt", "hybrid"):
            raise ValueError(
                f"solver must be 'lpt' or 'hybrid', got {self.solver!r}")

    def _partition(self, e, l, m, rng):
        if self.solver == "hybrid":
            from repro_torch.core.scheduler.ilp import solve_makespan_bnb
            return solve_makespan_bnb(e, l, m,
                                      time_limit_s=self.time_limit_s).groups
        from repro_torch.core.scheduler.lpt import lpt_schedule
        return lpt_schedule(e, l, m, refine=self.refine)

    def _partition_loads(self, e_s, l_s, m, seed):
        if self.solver == "hybrid" or self.refine:
            # exact / refining solvers stay per-trial
            return super()._partition_loads(e_s, l_s, m, seed)
        from repro_torch.core.scheduler.lpt import lpt_assign_batch
        _assign, e_b, l_b = lpt_assign_batch(e_s, l_s, m)
        return e_b, l_b

    def _aggregate(self, samples: np.ndarray) -> float:
        return float(np.quantile(samples, self.q))


# --------------------------------------------------------------------- #
_REGISTRY = {
    "mean": MeanObjective,
    "expected": ExpectedRandomObjective,          # legacy alias
    "expected-random": ExpectedRandomObjective,
    "balanced-quantile": BalancedQuantileObjective,
    "quantile": BalancedQuantileObjective,
}

OBJECTIVE_NAMES = ("mean", "expected-random", "balanced-quantile")


def get_objective(objective, **kwargs) -> Objective:
    """Resolve an objective name (or an instance).

    kwargs (``n_trials``, ``q``, ``solver``, ...) are forwarded to the
    class; keys a class does not accept are dropped so callers can pass a
    uniform configuration regardless of which objective is selected.
    An instance passes through untouched unless a provided kwarg differs
    from its current configuration, in which case a reconfigured *copy*
    is returned (the original is never mutated) — this is how the runtime
    controller applies its re-plan trial budget to an engine-pinned
    objective without losing the rest of its configuration."""
    if isinstance(objective, Objective):
        updates = {k: v for k, v in kwargs.items()
                   if v is not None and hasattr(objective, k)
                   and getattr(objective, k) != v}
        if not updates:
            return objective
        import copy
        out = copy.copy(objective)
        for k, v in updates.items():
            setattr(out, k, v)
        validate = getattr(out, "_validate", None)
        if validate is not None:
            validate()
        return out
    try:
        cls = _REGISTRY[objective]
    except KeyError:
        raise ValueError(
            f"unknown objective {objective!r}; expected one of "
            f"{sorted(set(_REGISTRY))}") from None
    import inspect
    accepted = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in kwargs.items()
                  if k in accepted and v is not None})
