"""The port's copy of the planner (profile → plan → schedule) against the
reference, on the CPU.

The planner is numpy with no tensor math, and the port keeps a copy of the
reference's code, so every result must be *equal*: floats, integer arrays,
plan tuples and groups alike, with no tolerance.  Inputs are made with numpy
from a seed.  The branch-and-bound scheduler stops on the wall clock
(``ilp.py`` checks it every 1024 nodes), so its tests either use instances
the search finishes under a generous limit (and assert ``solver == "ilp"``
on both sides) or stop on a node count with no time limit.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.configs import internvl2_2b as jinternvl
from repro.core.engine import DFLOPEngine as JEngine
from repro.core.optimizer import space as jspace
from repro.core.optimizer.search import ParallelismOptimizer as JOptimizer
from repro.core.pipeline import simulator as jsim
from repro.core.profiling import analytic as jan
from repro.core.profiling.data_profiler import DataProfiler as JDataProfiler
from repro.core.profiling.flops import module_flops as jflops
from repro.core.profiling.interpolation import GridInterpolator as JGrid
from repro.core.profiling.model_profiler import ModelProfiler as JProfiler
from repro.core.scheduler import ilp as jilp
from repro.core.scheduler import lpt as jlpt
from repro.core.scheduler.adaptive import AdaptiveCorrection as JAdaptive
from repro.core.scheduler.online import OnlineMicrobatchScheduler as JScheduler
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro_torch.common import types
from repro_torch.configs import internvl2_2b, jamba_v0_1_52b, rwkv6_7b
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer import memory_model
from repro_torch.core.optimizer import space
from repro_torch.core.optimizer.search import ParallelismOptimizer
from repro_torch.core.pipeline import simulator as sim
from repro_torch.core.profiling import analytic as an
from repro_torch.core.profiling.data_profiler import DataProfiler
from repro_torch.core.profiling.flops import module_flops
from repro_torch.core.profiling.interpolation import GridInterpolator
from repro_torch.core.profiling.model_profiler import ModelProfiler
from repro_torch.core.scheduler import ilp, lpt
from repro_torch.core.scheduler.adaptive import AdaptiveCorrection
from repro_torch.core.scheduler.online import OnlineMicrobatchScheduler
from repro_torch.data.synthetic import MixedDataset

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPM = 8                      # LLM tokens per media item at the tiny sizes


def _reference_tiny_configs():
    """``examples/train_mllm.py::tiny_configs`` (the reference's tiny MLLM)."""
    spec = importlib.util.spec_from_file_location(
        "train_mllm_example", os.path.join(ROOT, "examples", "train_mllm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.tiny_configs()


J_ENC, J_LLM, _ = _reference_tiny_configs()


def _port_cfg(jcfg):
    """The port's ``ModelConfig`` with the reference's field values.  The
    port has every field but ``scan_layers`` (how JAX lowers the stack),
    which no count reads; its own fields (``PORT_ONLY_FIELDS``) keep their
    defaults."""
    fields = {f.name for f in dataclasses.fields(types.ModelConfig)} - set(types.PORT_ONLY_FIELDS)
    assert {f.name for f in dataclasses.fields(jtypes.ModelConfig)} - fields == \
        {"scan_layers"}
    return types.ModelConfig(**{n: getattr(jcfg, n) for n in fields})


def _ref_cfg(cfg):
    return jtypes.ModelConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(types.ModelConfig)
                                 if f.name not in types.PORT_ONLY_FIELDS})


ENC, LLM = _port_cfg(J_ENC), _port_cfg(J_LLM)
FLOP_CFGS = {
    "enc-tiny": (J_ENC, ENC),
    "llm-tiny": (J_LLM, LLM),
    "internvit-300m": (jinternvl.ENCODER, internvl2_2b.ENCODER),
    "internlm2-1.8b": (jinternvl.LLM, internvl2_2b.LLM),
    # the Mamba, MoE and RWKV6 branches of the counts
    "jamba": (_ref_cfg(jamba_v0_1_52b.CFG), jamba_v0_1_52b.CFG),
    "rwkv6-7b": (_ref_cfg(rwkv6_7b.CFG), rwkv6_7b.CFG),
}


def test_port_configs_equal_reference_field_by_field():
    for n in ("ENCODER", "LLM"):
        a, b = getattr(jinternvl, n), getattr(internvl2_2b, n)
        for f in dataclasses.fields(types.ModelConfig):
            if f.name in types.PORT_ONLY_FIELDS:
                assert not getattr(b, f.name), (n, f.name)
            else:
                assert getattr(a, f.name) == getattr(b, f.name), (n, f.name)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", list(FLOP_CFGS))
def test_module_flops_matches_reference(name, mode):
    jcfg, cfg = FLOP_CFGS[name]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    rng = np.random.default_rng(0)
    for batch, seq in zip(rng.integers(1, 9, 6), rng.integers(1, 9000, 6)):
        cache = float(seq) * 1.5 if mode == "decode" else 0.0
        got = module_flops(cfg, float(batch), float(seq), mode=mode, cache_len=cache)
        want = jflops(jcfg, float(batch), float(seq), mode=mode, cache_len=cache)
        assert (got.attn, got.lin, got.total) == (want.attn, want.lin, want.total)


def test_mllm_param_count_matches_reference():
    assert internvl2_2b.CFG.param_count() == jinternvl.CFG.param_count()


@pytest.mark.parametrize("spec", ["V5E", "A100", "H100"])
def test_analytic_backend_matches_reference(spec):
    hw = getattr(an, spec)
    # the reference has no H100: its HardwareSpec with the port's fields
    jhw = jan.HardwareSpec(**dataclasses.asdict(hw))
    got, want = an.AnalyticBackend(hw), jan.AnalyticBackend(jhw)
    for jcfg, cfg in FLOP_CFGS.values():
        for mode in ("train", "prefill", "decode"):
            for split in ("all", "attn", "lin"):
                for tp in (1, 2, 4, 8):
                    for b, s in ((1.0, 256.0), (3.0, 1024.0), (8.0, 8192.0)):
                        assert got.throughput(cfg, b, s, tp, split=split, mode=mode) == \
                            want.throughput(jcfg, b, s, tp, split=split, mode=mode)
        for n_layers, tp, b, s in ((2, 1, 1.0, 4096.0), (4, 8, 16.0, 729.0)):
            assert got.memory(cfg, n_layers, tp, b, s) == \
                want.memory(jcfg, n_layers, tp, b, s)


def test_grid_interpolator_matches_reference():
    rng = np.random.default_rng(1)
    for k in (1, 2, 3):
        axes = [np.sort(rng.choice(np.arange(1, 200), size=rng.integers(1, 6),
                                   replace=False)).astype(float) for _ in range(k)]
        values = rng.standard_normal([len(a) for a in axes])
        # points inside and outside the hull (clamped extrapolation)
        pts = rng.uniform(-50, 250, (64, k))
        got = GridInterpolator(axes, values)
        want = JGrid(axes, values)
        np.testing.assert_array_equal(got.batch(pts), want.batch(pts))
        assert got(*pts[0]) == want(*pts[0])


def _perf_pair(enc, llm, jenc, jllm, e_seq_len=16, tps=(1, 2, 4)):
    return (ModelProfiler(an.AnalyticBackend(an.V5E), tp_degrees=tps)
            .profile_mllm(enc, llm, e_seq_len),
            JProfiler(jan.AnalyticBackend(jan.V5E), tp_degrees=tps)
            .profile_mllm(jenc, jllm, e_seq_len))


def _grids(mp):
    out = [mp.thr_all.grid, mp.memory.model_state_grid, mp.memory.act_state_grid]
    out += [t.grid for t in (mp.thr_attn, mp.thr_lin) if t is not None]
    return out


def test_profile_mllm_grids_match_reference():
    perf, jperf = _perf_pair(ENC, LLM, J_ENC, J_LLM)
    for mp, jmp in ((perf.encoder, jperf.encoder), (perf.llm, jperf.llm)):
        assert mp.fixed_seq == jmp.fixed_seq
        for g, jg in zip(_grids(mp), _grids(jmp), strict=True):
            for a, b in zip(g.axes, jg.axes, strict=True):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(g.values, jg.values)
    shapes = np.random.default_rng(2).uniform(0, 9000, 50)
    for tp in (1, 2, 4):
        np.testing.assert_array_equal(perf.e_dur_batch(shapes / 100, tp),
                                      jperf.e_dur_batch(shapes / 100, tp))
        np.testing.assert_array_equal(perf.l_dur_batch(shapes, tp),
                                      jperf.l_dur_batch(shapes, tp))
        assert perf.l_dur(1234.5, tp) == jperf.l_dur(1234.5, tp)
        assert perf.e_dur(3.5, tp) == jperf.e_dur(3.5, tp)


def _dists(n=512, seed=0):
    dist = DataProfiler(TPM).profile_sampler(
        MixedDataset("mixed", seed=seed, tokens_per_media_item=TPM), n)
    jdist = JDataProfiler(TPM).profile_sampler(
        JMixedDataset("mixed", seed=seed, tokens_per_media_item=TPM), n)
    return dist, jdist


def test_data_profiler_matches_reference():
    dist, jdist = _dists()
    np.testing.assert_array_equal(dist.enc_batches, jdist.enc_batches)
    np.testing.assert_array_equal(dist.llm_seqs, jdist.llm_seqs)
    assert (dist.mean(), dist.variance("llm"), dist.variance("enc"),
            dist.heterogeneity()) == (jdist.mean(), jdist.variance("llm"),
                                      jdist.variance("enc"), jdist.heterogeneity())
    for a, b in zip(dist.histogram("llm"), jdist.histogram("llm")):
        np.testing.assert_array_equal(a, b)
    items = MixedDataset("mixed", seed=4, tokens_per_media_item=TPM).sample(300)
    jitems = JMixedDataset("mixed", seed=4, tokens_per_media_item=TPM).sample(300)
    sub = DataProfiler(TPM).profile(items, n_samples=100, seed=9)
    jsub = JDataProfiler(TPM).profile(jitems, n_samples=100, seed=9)
    np.testing.assert_array_equal(sub.llm_seqs, jsub.llm_seqs)
    np.testing.assert_array_equal(sub.enc_batches, jsub.enc_batches)


CLUSTER = dict(n_chips=8, chips_per_node=4)


def _search_pair(objective, gbs=32, **kw):
    perf, jperf = _perf_pair(ENC, LLM, J_ENC, J_LLM)
    dist, jdist = _dists()
    opt = ParallelismOptimizer(space.ClusterSpec(**CLUSTER), perf, objective=objective,
                               keep_history=True, **kw)
    jopt = JOptimizer(jspace.ClusterSpec(**CLUSTER), jperf, objective=objective,
                      keep_history=True, **kw)
    return opt.search(dist, gbs), jopt.search(jdist, gbs), (opt, perf, dist), \
        (jopt, jperf, jdist)


@pytest.mark.parametrize("objective,kw", [
    ("mean", {}),
    ("expected-random", {"seed": 3, "n_trials": 16}),
    ("balanced-quantile", {"seed": 5, "n_trials": 16}),
])
def test_search_matches_reference(objective, kw):
    got, want, (opt, perf, dist), (jopt, jperf, jdist) = _search_pair(objective, **kw)
    assert got.found and want.found
    assert got.plan.as_tuple() == want.plan.as_tuple()
    assert (got.makespan, got.n_configs, got.n_feasible) == \
        (want.makespan, want.n_configs, want.n_feasible)
    assert got.history == want.history           # every configuration's score
    # the objective's score of the chosen plan
    jplan = jspace.ParallelismPlan(
        llm=jspace.ModuleParallelism(*got.plan.as_tuple()[3:6]),
        encoder=jspace.ModuleParallelism(*got.plan.as_tuple()[:3]),
        n_mb=got.plan.n_mb, schedule=got.plan.schedule)
    assert opt.objective_obj.evaluate(perf, got.plan, dist, 32, seed=7) == \
        jopt.objective_obj.evaluate(jperf, jplan, jdist, 32, seed=7)


def test_baseline_uniform_matches_reference():
    perf, jperf = _perf_pair(ENC, LLM, J_ENC, J_LLM)
    dist, jdist = _dists()
    opt = ParallelismOptimizer(space.ClusterSpec(**CLUSTER), perf)
    jopt = JOptimizer(jspace.ClusterSpec(**CLUSTER), jperf)
    for tp, pp in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (3, 1)):
        got = opt.baseline_uniform(dist, 32, tp, pp)
        want = jopt.baseline_uniform(jdist, 32, tp, pp)
        assert (got.plan is None) == (want.plan is None)
        if got.plan is not None:
            assert got.plan.as_tuple() == want.plan.as_tuple()
        assert (got.makespan, got.n_configs, got.n_feasible) == \
            (want.makespan, want.n_configs, want.n_feasible)


def _trace_equal(a, b):
    for f in ("makespan", "idle_fraction", "total_idle"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)))
    for f in ("op_start", "op_end"):
        if getattr(b, f, None) is not None:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_simulate_1f1b_batch_matches_reference():
    rng = np.random.default_rng(3)
    for lead, p, m in (((), 1, 1), ((3,), 2, 4), ((2, 3), 4, 7), ((5,), 3, 2)):
        fwd = rng.uniform(0.1, 2.0, lead + (p, m))
        bwd = rng.uniform(0.1, 4.0, lead + (p, m))
        for b in (None, bwd):
            _trace_equal(sim.simulate_1f1b_batch(fwd, b, record_ops=True),
                         jsim.simulate_1f1b_batch(fwd, b, record_ops=True))


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved", "encoder_fill"])
def test_simulate_schedule_batch_matches_reference(schedule):
    rng = np.random.default_rng(4)
    for lead, p, m in (((2,), 2, 4), ((3,), 4, 8), ((), 3, 6)):
        fwd = rng.uniform(0.1, 2.0, lead + (p, m))
        bwd = rng.uniform(0.1, 4.0, lead + (p, m))
        kw = {}
        if schedule == "encoder_fill":
            kw = dict(e_fwd=rng.uniform(0.05, 1.0, lead + (p, m)),
                      e_bwd=rng.uniform(0.05, 2.0, lead + (p, m)))
        _trace_equal(sim.simulate_schedule_batch(schedule, fwd, bwd, record_ops=True, **kw),
                     jsim.simulate_schedule_batch(schedule, fwd, bwd, record_ops=True, **kw))


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved", "encoder_fill"])
def test_simulate_bucket_ranks_batch_matches_reference(schedule):
    rng = np.random.default_rng(5)
    n_mb, dp, e_pp, l_pp = 4, 2, 1, 3
    if schedule == "encoder_fill":
        e_pp = 0
    m = n_mb * dp
    e_b = rng.uniform(0.0, 1.0, (6, m))
    l_b = rng.uniform(0.1, 2.0, (6, m))
    kw = dict(n_mb=n_mb, dp=dp, e_pp=e_pp, l_pp=l_pp, schedule=schedule)
    got = sim.simulate_bucket_ranks_batch(e_b, l_b, **kw)
    want = jsim.simulate_bucket_ranks_batch(e_b, l_b, **kw)
    _trace_equal(got, want)


def test_lpt_schedule_matches_reference():
    rng = np.random.default_rng(6)
    for n, m in ((1, 1), (5, 2), (24, 4), (100, 8), (33, 5)):
        e, l = rng.uniform(0, 10, n), rng.uniform(0.01, 10, n)
        for refine in (True, False):
            got = lpt.lpt_schedule(e, l, m, refine=refine)
            assert got == jlpt.lpt_schedule(e, l, m, refine=refine)
            assert lpt.cmax(e, l, got) == jlpt.cmax(e, l, got)
        assert lpt.lower_bound(e, l, m) == jlpt.lower_bound(e, l, m)


def test_solve_makespan_bnb_matches_reference():
    """Stops on the node count (no time limit) or runs to the end."""
    rng = np.random.default_rng(7)
    for n, m, nodes in ((8, 3, 2_000_000), (12, 4, 2_000_000), (40, 6, 5_000)):
        e, l = rng.uniform(0, 10, n), rng.uniform(0.01, 10, n)
        got = ilp.solve_makespan_bnb(e, l, m, time_limit_s=float("inf"), node_limit=nodes)
        want = jilp.solve_makespan_bnb(e, l, m, time_limit_s=float("inf"), node_limit=nodes)
        assert (got.groups, got.cmax, got.optimal, got.nodes, got.timed_out) == \
            (want.groups, want.cmax, want.optimal, want.nodes, want.timed_out)


def _scheduler_pair(plan_kw, time_limit=60.0):
    perf, jperf = _perf_pair(ENC, LLM, J_ENC, J_LLM)
    mk = lambda s, ep, lp: s.ParallelismPlan(  # noqa: E731
        llm=s.ModuleParallelism(*lp), encoder=ep and s.ModuleParallelism(*ep),
        n_mb=plan_kw["n_mb"], schedule=plan_kw.get("schedule", "1f1b"))
    ep, lp = plan_kw.get("encoder"), plan_kw["llm"]
    return (OnlineMicrobatchScheduler(mk(space, ep, lp), perf, TPM,
                                      ilp_time_limit_s=time_limit,
                                      adaptive=AdaptiveCorrection()),
            JScheduler(mk(jspace, ep, lp), jperf, TPM, ilp_time_limit_s=time_limit,
                       adaptive=JAdaptive()))


def _out_equal(a, b):
    assert (a.groups, a.cmax, a.lower_bound, a.solver, a.imbalance, a.step_makespan) == \
        (b.groups, b.cmax, b.lower_bound, b.solver, b.imbalance, b.step_makespan)
    np.testing.assert_array_equal(a.e_dur, b.e_dur)
    np.testing.assert_array_equal(a.l_dur, b.l_dur)


@pytest.mark.parametrize("plan_kw", [
    dict(llm=(1, 1, 1), n_mb=4),
    dict(llm=(2, 1, 1), encoder=(1, 1, 1), n_mb=2),
    dict(llm=(1, 2, 2), encoder=(1, 1, 2), n_mb=2, schedule="encoder_fill"),
])
def test_online_scheduler_matches_reference(plan_kw):
    sched, jsched = _scheduler_pair(plan_kw)
    ds = MixedDataset("mixed", seed=2, tokens_per_media_item=TPM)
    jds = JMixedDataset("mixed", seed=2, tokens_per_media_item=TPM)
    for _ in range(3):
        items, jitems = ds.sample(8), jds.sample(8)
        got, want = sched.schedule(items), jsched.schedule(jitems)
        assert got.solver == want.solver == "ilp"
        _out_equal(got, want)
        assert sorted(i for g in got.groups for i in g) == list(range(8))
        for seed in (0, 11):
            _out_equal(sched.schedule_random(items, seed=seed),
                       jsched.schedule_random(jitems, seed=seed))
        # the adaptive correction sees the same feedback on both sides
        for s, d in ((300.0, 0.01), (2000.0, 0.05)):
            sched.observe("llm", s, d, 1.3 * d)
            jsched.observe("llm", s, d, 1.3 * d)


def test_engine_profile_plan_schedule_matches_reference():
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=TPM)
    jds = JMixedDataset("mixed", seed=0, tokens_per_media_item=TPM)
    eng = DFLOPEngine(llm_cfg=LLM, enc_cfg=ENC, e_seq_len=16,
                      cluster=space.ClusterSpec(**CLUSTER), tokens_per_media_item=TPM,
                      backend=an.AnalyticBackend(an.V5E))
    jeng = JEngine(llm_cfg=J_LLM, enc_cfg=J_ENC, e_seq_len=16,
                   cluster=jspace.ClusterSpec(**CLUSTER), tokens_per_media_item=TPM,
                   backend=jan.AnalyticBackend(jan.V5E))
    eng.profile(ds, n_samples=256)
    jeng.profile(jds, n_samples=256)
    np.testing.assert_array_equal(eng.dist.llm_seqs, jeng.dist.llm_seqs)
    got, want = eng.plan(gbs=32), jeng.plan(gbs=32)
    assert got.plan.as_tuple() == want.plan.as_tuple()
    assert (got.makespan, got.n_configs, got.n_feasible) == \
        (want.makespan, want.n_configs, want.n_feasible)
    b, jb = eng.baseline_plan(32, 2, 2), jeng.baseline_plan(32, 2, 2)
    assert (b.plan.as_tuple(), b.makespan) == (jb.plan.as_tuple(), jb.makespan)
    sched = eng.scheduler(ilp_time_limit_s=60.0)
    jsched = jeng.scheduler(ilp_time_limit_s=60.0)
    items, jitems = ds.sample(8), jds.sample(8)
    got_s, want_s = sched.schedule(items), jsched.schedule(jitems)
    assert got_s.solver == want_s.solver == "ilp"
    _out_equal(got_s, want_s)


def test_engine_closed_loops_stay_unported():
    """Both closed loops are ported: ``runtime()`` (held against the
    reference in ``tests/test_torch_runtime.py``) and ``serving()`` (in
    ``tests/test_torch_serve_engine.py``).  As the reference's do, each
    needs ``profile()`` first: on an unprofiled engine both raise the
    reference's own ``AssertionError``, in both packages."""
    eng = DFLOPEngine(llm_cfg=LLM, cluster=space.ClusterSpec(**CLUSTER))
    jeng = JEngine(llm_cfg=J_LLM, cluster=jspace.ClusterSpec(**CLUSTER))
    for e in (eng, jeng):
        with pytest.raises(AssertionError, match=r"call profile\(\) first"):
            e.runtime(8)
        with pytest.raises(AssertionError, match=r"call profile\(\) first"):
            e.serving()


def test_engine_prices_with_h100_by_default():
    """The default backend is the H100 spec, and InternVL2-2B's plan on
    eight 80 GB cards is one the memory model admits."""
    h100 = space.ClusterSpec(n_chips=8, chips_per_node=8, mem_bytes=an.H100.mem_bytes,
                             name="h100-sxm")
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=256)
    eng = DFLOPEngine(llm_cfg=internvl2_2b.LLM, enc_cfg=internvl2_2b.ENCODER,
                      e_seq_len=1024, cluster=h100, tokens_per_media_item=256)
    eng.profile(ds, n_samples=256)
    want = ModelProfiler(an.AnalyticBackend(an.H100), tp_degrees=(1, 2, 4, 8)).profile_mllm(
        internvl2_2b.ENCODER, internvl2_2b.LLM, 1024)
    for mp, wmp in ((eng.perf.encoder, want.encoder), (eng.perf.llm, want.llm)):
        for g, wg in zip(_grids(mp), _grids(wmp), strict=True):
            np.testing.assert_array_equal(g.values, wg.values)
    # the H100 differs from the reference's default TPU pricing
    v5e = ModelProfiler(an.AnalyticBackend(an.V5E), tp_degrees=(1, 2, 4, 8)).profile_llm(
        internvl2_2b.LLM)
    assert not np.array_equal(eng.perf.llm.thr_all.grid.values, v5e.thr_all.grid.values)
    res = eng.plan(gbs=64)
    assert res.found and np.isfinite(res.makespan) and res.n_feasible > 0
    plan = res.plan
    assert plan.schedule != "encoder_fill"         # Eq. 4/5 price its stages apart
    mean_b, mean_s = eng.dist.mean()
    m = plan.n_buckets                             # shapes per microbatch and rank
    assert memory_model.feasible(eng.perf.encoder, eng.perf.llm, plan.encoder, plan.llm,
                                 mean_b * 64 / m, mean_s * 64 / m, an.H100.mem_bytes)
    assert plan.chips <= 8
