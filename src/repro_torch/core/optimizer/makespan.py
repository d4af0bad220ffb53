"""Makespan model primitives (paper §3.3.1).

    T = (N_mb + E_pp + L_pp − 1) · max(E_dur, L_dur)

Stage durations follow Algorithm 1 lines 25–26: module FLOPs for the
microbatch's (mean) shape, divided by the profiled throughput of its TP
group and by its pipeline degree.

How a *plan* is scored against a whole shape distribution lives in
`repro.core.optimizer.objective` (the pluggable Eq. 1 estimators: ``mean``,
``expected-random``, ``balanced-quantile``).  This module keeps the closed
forms they build on, plus the legacy aggregate-shape Monte-Carlo
(`expected_makespan`) retained for reference comparisons.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.optimizer.space import ModuleParallelism, ParallelismPlan
from repro_torch.core.profiling.data_profiler import ShapeDistribution
from repro_torch.core.profiling.model_profiler import PerfModel


def pipeline_makespan(n_mb: int, e_pp: int, l_pp: int, e_dur, l_dur):
    """(N_mb + depth − 1) · max(E_dur, L_dur) — elementwise over arrays, so
    the sampling objectives score a whole batch of Monte-Carlo trials in
    one call (scalars in → numpy scalar out, a drop-in ``float``).

    >>> float(pipeline_makespan(4, 1, 2, 1.0, 3.0))
    18.0
    """
    return (n_mb + e_pp + l_pp - 1) * np.maximum(e_dur, l_dur)


def schedule_makespan(plan: ParallelismPlan, e_dur, l_dur):
    """Closed-form step estimate (N_mb + bubble_slots) · slot cost for any
    schedule family, elementwise over arrays (see ``docs/schedules.md``).

    ``e_dur`` follows each family's own per-stage convention: already
    divided by E_pp for the staged families; the *full* per-microbatch
    encoder duration under ``encoder_fill`` (its colocated E_pp is 1),
    which this function splits over the L_pp replicas.  The chunk then
    runs *serial* with the rank's LLM work, so the encoder_fill slot costs
    the sum — a (deliberately conservative: real bubble-filling overlaps
    part of it) upper estimate the sampling objectives' ``"simulate"``
    mode refines.  For ``schedule="1f1b"`` this is exactly
    `pipeline_makespan`.

    >>> lp = ModuleParallelism(1, 2, 1)
    >>> ep = ModuleParallelism(1, 1, 1)
    >>> float(schedule_makespan(ParallelismPlan(llm=lp, encoder=ep, n_mb=4,
    ...                                         schedule="encoder_fill"),
    ...                         1.0, 3.0))                # (4+1)·(3 + 1/2)
    17.5
    """
    if plan.schedule == "encoder_fill":
        return (plan.n_mb + plan.bubble_slots) \
            * (np.asarray(e_dur) / plan.llm.pp + l_dur)
    return (plan.n_mb + plan.bubble_slots) * np.maximum(e_dur, l_dur)


def accepts_fallback(fn) -> bool:
    """True if a corrector function takes a `fallback_shape` keyword —
    checked via signature, never by a trial call (a probe call would
    double-invoke stateful correctors and mask their real TypeErrors)."""
    import inspect
    try:
        return "fallback_shape" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def correct_scalar(corrector, module: str, shape: float, tp: int,
                   dur: float, fallback_shape: Optional[float] = None) -> float:
    """Scalar `DurationCorrector` application, forwarding `fallback_shape`
    only to correctors whose `correct` accepts it (see
    `OnlineCalibrator.correct` for the fallback semantics)."""
    if corrector is None:
        return dur
    if fallback_shape is not None and accepts_fallback(corrector.correct):
        return corrector.correct(module, shape, tp, dur,
                                 fallback_shape=fallback_shape)
    return corrector.correct(module, shape, tp, dur)


def stage_durations(perf: PerfModel, ep: Optional[ModuleParallelism],
                    lp: ModuleParallelism, t_bsz: float, t_seq: float,
                    mode: str = "train") -> Tuple[float, float]:
    """(E_dur, L_dur) for one microbatch of mean shape (t_bsz, t_seq)."""
    e_dur = 0.0
    if perf.encoder is not None and ep is not None and t_bsz > 0:
        fl = perf.encoder.flops(t_bsz, perf.encoder.fixed_seq, mode).total
        thr = perf.encoder.thr_all(t_bsz, ep.tp)
        e_dur = fl / (thr * ep.pp)
    fl_l = perf.llm.flops(1.0, t_seq, mode)
    if perf.llm.thr_attn is not None:
        l_dur = (fl_l.attn / perf.llm.thr_attn(t_seq, lp.tp)
                 + fl_l.lin / perf.llm.thr_lin(t_seq, lp.tp)) / lp.pp
    else:
        l_dur = fl_l.total / (perf.llm.thr_all(t_seq, lp.tp) * lp.pp)
    return e_dur, l_dur


def mean_makespan(perf: PerfModel, plan: ParallelismPlan,
                  mean_bsz: float, mean_seq: float, gbs: int,
                  mode: str = "train", corrector=None) -> float:
    """Algorithm 1's mean-shape estimate for plan θ.

    corrector: optional `objective.DurationCorrector`.  Corrections are
    multiplicative ratios, so applying them to the per-stage (already /pp)
    duration equals correcting the TP-group duration — the same keying
    `search._ModuleTables` uses."""
    i = plan.n_mb
    ep, lp = plan.encoder, plan.llm
    t_bsz = mean_bsz * gbs / (i * ep.dp) if ep else 0.0
    t_seq = mean_seq * gbs / (i * lp.dp)
    e_dur, l_dur = stage_durations(perf, ep, lp, t_bsz, t_seq, mode)
    if corrector is not None:
        if ep is not None and e_dur > 0:
            e_dur = correct_scalar(corrector, "encoder", t_bsz, ep.tp,
                                   e_dur, fallback_shape=mean_bsz)
        l_dur = correct_scalar(corrector, "llm", t_seq, lp.tp, l_dur,
                               fallback_shape=mean_seq)
    return float(schedule_makespan(plan, e_dur, l_dur))


def expected_makespan(perf: PerfModel, plan: ParallelismPlan,
                      dist: ShapeDistribution, gbs: int, *,
                      n_trials: int = 16, seed: int = 0,
                      mode: str = "train") -> float:
    """Legacy Eq. 1 Monte-Carlo (aggregate-shape semantics).

    Samples `n_trials` random global batches from the empirical
    distribution, randomly partitions each into N_mb·L_dp buckets and takes
    the slowest bucket as the stage duration (random assignment — the
    baseline the Online Scheduler improves on).  Bucket durations are
    computed from the *summed* shape; the objective subsystem
    (`objective.ExpectedRandomObjective`) instead sums per-item durations,
    matching what the scheduler's C_max actually measures — prefer it."""
    rng = np.random.default_rng(seed)
    i, ep, lp = plan.n_mb, plan.encoder, plan.llm
    m = i * lp.dp
    n = len(dist)
    if n == 0:
        mean_bsz, mean_seq = 1.0, 1.0
        return mean_makespan(perf, plan, mean_bsz, mean_seq, gbs, mode)
    total = 0.0
    for _ in range(n_trials):
        idx = rng.integers(0, n, size=gbs)
        buckets = rng.integers(0, m, size=gbs)
        e_b = np.bincount(buckets, weights=dist.enc_batches[idx], minlength=m)
        s_b = np.bincount(buckets, weights=dist.llm_seqs[idx], minlength=m)
        # encoder buckets are grouped over E_dp, LLM buckets over L_dp: use
        # the per-bucket mean shape within each module's own grouping.
        if ep is not None:
            scale = lp.dp / ep.dp     # rebalance bucket count mismatch
            e_shapes = e_b * scale
            e_durs = np.array([
                perf.encoder.flops(b, perf.encoder.fixed_seq, mode).total
                / (perf.encoder.thr_all(b, ep.tp) * ep.pp)
                if b > 0 else 0.0 for b in e_shapes])
            e_dur = float(e_durs.max())
            e_pp = ep.pp
        else:
            e_dur, e_pp = 0.0, 0
        l_durs = perf.l_dur_batch(s_b, lp.tp, mode) / lp.pp
        l_dur = float(l_durs.max())
        total += pipeline_makespan(i, e_pp, lp.pp, e_dur, l_dur)
    return total / n_trials
