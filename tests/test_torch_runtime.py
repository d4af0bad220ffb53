"""The port's copy of the runtime control loop (trace, metrics, calibration,
drift, controller) against the reference, on the CPU.

The runtime is numpy with no tensor math, and the port keeps a copy of the
reference's code, so every result must be *equal* to the reference's, apart
from fields that read the wall clock (``elapsed_s`` and what is averaged from
it, trace timestamps).  Inputs are made with numpy from a seed.  The trace
recorders take the same counting clock, so their exports are equal whole.

The controller's branch-and-bound scheduler reads the wall clock every 1024
nodes (``ilp.py``); it runs with a time limit of 0, so it stops at its
1024th node or finishes before, on both sides alike.  Every batch is
followed by ``drain()``, so a background re-plan is adopted at the same
batch on both sides whatever the threads' timing.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.core.engine import DFLOPEngine as JEngine
from repro.core.optimizer import space as jspace
from repro.core.profiling import analytic as jan
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.runtime import calibration as jcal
from repro.runtime import drift as jdrift
from repro.runtime import metrics as jmetrics
from repro.runtime import trace as jtrace
from repro_torch.common import types
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer import space
from repro_torch.core.profiling import analytic as an
from repro_torch.data.synthetic import MixedDataset
from repro_torch.runtime import calibration, drift, metrics, trace
from repro_torch.runtime import (DriftDetector, OnlineCalibrator, ReplanRecord,
                                 RuntimeController, RuntimeMetrics, TraceRecorder)

torch.set_num_threads(1)

TPM = 64
ENC = types.ModelConfig(name="e", family="vlm-enc", n_layers=4, d_model=256,
                        n_heads=4, n_kv_heads=4, d_ff=1024, vocab_size=0,
                        causal=False, use_rope=False, input_embed_dim=64,
                        has_lm_head=False)
LLM = types.ModelConfig(name="l", family="dense", n_layers=8, d_model=512,
                        n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=8192)


def _ref_cfg(cfg):
    return jtypes.ModelConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(types.ModelConfig)
                                 if f.name not in types.PORT_ONLY_FIELDS})


def _clock():
    """A clock that advances 1.5 ms a reading, the same on both sides."""
    c = itertools.count()
    return lambda: next(c) * 1.5e-3


def _drive_trace(rec):
    rec.name_thread(0, "control-loop")
    rec.name_thread(1, "replan-search")
    with rec.span("schedule", cat="scheduler", batch=0, n_items=8):
        rec.counter("imbalance", 0.125)
    rec.complete("step", 10.0, 250.5, cat="step", args={"pred_cmax_s": 0.25})
    rec.instant("drift:shape-ks", cat="drift", args={"statistic": 0.4, "n_obs": 64})
    with rec.span("replan-search", cat="replan", tid=1, kind="shape-ks"):
        pass
    rec.complete("empty", 0.0, -1.0)                   # negative durations clip
    rec.counter("bubble_fraction", np.float64(0.3))
    with rec.span("bare"):
        pass


@pytest.mark.parametrize("enabled,max_events", [(True, 1_000_000), (True, 4),
                                                (False, 1_000_000)])
def test_trace_export_matches_reference(enabled, max_events, tmp_path):
    got = TraceRecorder(enabled=enabled, max_events=max_events, clock=_clock())
    want = jtrace.TraceRecorder(enabled=enabled, max_events=max_events,
                                clock=_clock())
    _drive_trace(got)
    _drive_trace(want)
    assert (len(got), got.dropped) == (len(want), want.dropped)
    assert got.to_chrome() == want.to_chrome()
    path = got.export(str(tmp_path / "sub" / "t.json"))
    assert json.load(open(path)) == json.loads(json.dumps(want.to_chrome()))


def _drive_metrics(m, seed):
    rng = np.random.default_rng(seed)
    for i in range(300):                     # past the 256-long windows
        out = type("Out", (), dict(imbalance=float(rng.random() * 0.1),
                                   elapsed_s=float(rng.random() * 1e-3),
                                   cmax=float(rng.random())))
        m.record_schedule(out)
        busy = None if i % 3 else float(rng.random())
        stage = rng.random(3) if i % 5 == 0 else None
        m.record_step(float(rng.random() + 0.5), float(rng.random() * 0.1),
                      busy, stage)
        m.record_moe(float("nan") if i % 2 else float(rng.random()),
                     float("nan") if i % 4 else float(rng.random()))
        m.record_prediction("llm" if i % 2 else "encoder", float(rng.random()),
                            float(rng.random()) if i % 7 else 0.0)
        if i % 10 == 0:
            m.record_pack(int(rng.integers(0, 100)))
            m.record_reshard(float(rng.random()))
            m.record_membership(("join", "leave", "fail")[i % 3])
            m.record_recovery(float(rng.random()), degraded=bool(i % 20))
            m.record_compose(type("St", (), dict(elapsed_s=1e-3,
                                                 pred_gain=float(rng.random() + 1),
                                                 window_fill=int(rng.integers(16, 64)),
                                                 n_forced=int(rng.integers(0, 4)))))
            m.record_admission(int(rng.integers(0, 9)), 4, float(rng.random()))
            m.record_decode_step(float(rng.random()), float(rng.random()))
            m.record_completion(float(rng.random()), float(rng.random()) - 0.2,
                                bool(i % 3))
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_snapshot_matches_reference(seed):
    got = _drive_metrics(RuntimeMetrics(), seed)
    want = _drive_metrics(jmetrics.RuntimeMetrics(), seed)
    assert got.snapshot() == want.snapshot()
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())
    for q in (0.0, 0.5, 0.99, 1.0):
        assert got.latency_s.quantile(q) == want.latency_s.quantile(q)


def test_empty_metrics_snapshot_matches_reference():
    assert RuntimeMetrics().snapshot() == jmetrics.RuntimeMetrics().snapshot()
    assert metrics.nan_to_none(float("nan")) is None
    s, js = metrics.RollingStat(4), jmetrics.RollingStat(4)
    for x in (3.0, 1.0, 4.0, 1.0, 5.0, 9.0):
        s.add(x)
        js.add(x)
    assert (s.mean(), s.max(), s.last(), s.quantile(0.5), len(s), s.count) == \
        (js.mean(), js.max(), js.last(), js.quantile(0.5), len(js), js.count)


def _observations(seed, n=400):
    rng = np.random.default_rng(seed)
    mods = rng.choice(["llm", "encoder"], n)
    shapes = np.exp(rng.uniform(0, 10, n))
    tps = rng.choice([1, 2, 4], n)
    pred = rng.uniform(-0.1, 1.0, n)
    actual = pred * rng.lognormal(0.2, 0.6, n)
    actual[rng.random(n) < 0.05] = 0.0
    return list(zip(mods, shapes, tps, pred, actual))


@pytest.mark.parametrize("kw", [{}, dict(alpha=0.5, min_obs=1, deadband=0.0),
                                dict(max_ratio=1.5, min_obs=4, deadband=0.1)])
def test_calibrator_matches_reference(kw):
    got, want = OnlineCalibrator(**kw), jcal.OnlineCalibrator(**kw)
    for obs in _observations(3):
        got.observe(*obs)
        want.observe(*obs)
    assert got.snapshot() == want.snapshot()
    for mod in (None, "llm", "encoder", "connector"):
        assert got.residual(mod) == want.residual(mod)
    rng = np.random.default_rng(5)
    shapes = np.exp(rng.uniform(0, 11, 256))
    pred = rng.random(256)
    for mod, tp, fb in itertools.product(("llm", "encoder"), (1, 2, 8),
                                         (None, 300.0)):
        np.testing.assert_array_equal(got.correct_array(mod, shapes, tp, pred, fb),
                                      want.correct_array(mod, shapes, tp, pred, fb))
        assert [got.correct(mod, s, tp, p, fb) for s, p in zip(shapes, pred)] == \
            [want.correct(mod, s, tp, p, fb) for s, p in zip(shapes, pred)]
    np.testing.assert_array_equal(calibration.shape_bucket_array(shapes),
                                  jcal.shape_bucket_array(shapes))
    assert [calibration.shape_bucket(s) for s in shapes] == \
        [jcal.shape_bucket(s) for s in shapes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_page_hinkley_matches_reference(seed):
    rng = np.random.default_rng(seed)
    stream = np.concatenate([rng.normal(0.1, 0.05, 200), rng.normal(0.6, 0.2, 200),
                             rng.normal(0.2, 0.1, 200)])
    ph = drift.PageHinkley(delta=0.005, threshold=0.5, burn_in=20)
    jph = jdrift.PageHinkley(delta=0.005, threshold=0.5, burn_in=20)
    fired = []
    for i, x in enumerate(stream):
        a, b = ph.update(float(x)), jph.update(float(x))
        assert (a, ph.statistic, ph.mean, ph.n) == (b, jph.statistic, jph.mean, jph.n)
        if a:
            fired.append(i)
            ph.reset()
            jph.reset()
    assert fired                              # the shift fires the test
    for n_a, n_b in ((0, 5), (7, 0), (50, 80), (300, 300)):
        a, b = rng.normal(size=n_a), rng.normal(0.3, 1.2, size=n_b)
        assert drift.ks_distance(a, b) == jdrift.ks_distance(a, b)


def _drift_run(mod, ds_cls, *, ph_burn_in):
    """The same item stream through a detector: a single-image reference,
    then video (rebased onto it at batch 15); a residual stream that shifts
    at batch 18, once the shapes are quiet."""
    det = mod.DriftDetector(window=64, check_every=16, cooldown=32,
                            ph_burn_in=ph_burn_in)
    ref = ds_cls("single_image", seed=0, tokens_per_media_item=TPM)
    items = ref.sample(256)
    det.set_reference(type("Dist", (), dict(
        enc_batches=np.array([it.encoder_batch() for it in items], float),
        llm_seqs=np.array([it.llm_seq_len(TPM) for it in items], float))))
    pre, post = (ds_cls(m, seed=s, tokens_per_media_item=TPM)
                 for m, s in (("single_image", 1), ("video", 2)))
    rng = np.random.default_rng(0)
    log = []
    for b in range(28):
        ev = det.observe_items((pre if b < 6 else post).sample(16), TPM)
        log.append(None if ev is None else dataclasses.astuple(ev))
        for _ in range(4):
            ev = det.observe_residual(float(abs(rng.normal(0.05 if b < 18 else 0.8, 0.05))))
            log.append(None if ev is None else dataclasses.astuple(ev))
        if b == 15:
            wd = det.window_distribution()
            log.append((wd.enc_batches.tolist(), wd.llm_seqs.tolist()))
            det.rebase()
    return log, [dataclasses.astuple(e) for e in det.events]


@pytest.mark.parametrize("ph_burn_in", [30, 4])
def test_drift_detector_matches_reference(ph_burn_in):
    got = _drift_run(drift, MixedDataset, ph_burn_in=ph_burn_in)
    want = _drift_run(jdrift, JMixedDataset, ph_burn_in=ph_burn_in)
    assert got == want
    kinds = {e[0] for e in got[1]}
    assert "shape-ks" in kinds and "residual-ph" in kinds


# --------------------------------------------------------------------- #
# controller
# --------------------------------------------------------------------- #
def _engines(objective="mean"):
    """The same engine on both sides, priced by the reference's V5E spec."""
    cl = dict(n_chips=32, chips_per_node=8, mem_bytes=80e9)
    eng = DFLOPEngine(llm_cfg=LLM, enc_cfg=ENC, e_seq_len=64,
                      cluster=space.ClusterSpec(**cl), tokens_per_media_item=TPM,
                      backend=an.AnalyticBackend(an.V5E), objective=objective)
    jeng = JEngine(llm_cfg=_ref_cfg(LLM), enc_cfg=_ref_cfg(ENC), e_seq_len=64,
                   cluster=jspace.ClusterSpec(**cl), tokens_per_media_item=TPM,
                   backend=jan.AnalyticBackend(jan.V5E), objective=objective)
    eng.profile(MixedDataset("single_image", seed=0, tokens_per_media_item=TPM),
                n_samples=512)
    jeng.profile(JMixedDataset("single_image", seed=0, tokens_per_media_item=TPM),
                 n_samples=512)
    return eng, jeng


def _trace_by_thread(ctl):
    """(ph, name, cat, tid, args) of each thread's events in order:
    timestamps left out, and the background search's events kept apart
    from the loop's (the threads interleave by timing)."""
    evs = [e for e in ctl.trace.to_chrome()["traceEvents"] if e["ph"] != "M"]
    return {tid: [(e["ph"], e["name"], e["cat"], e.get("args")) for e in evs
                  if e["tid"] == tid] for tid in {e["tid"] for e in evs}}


def _run_controller(eng, ds_cls, gbs, n_pre, n_post, *, compose_window=0, **kw):
    ctl = eng.runtime(gbs, ilp_time_limit_s=0.0, compose_window=compose_window,
                      drift=eng_drift(eng), **kw)
    plan0 = ctl.plan.as_tuple()
    pre = ds_cls("single_image", seed=1, tokens_per_media_item=TPM)
    post = ds_cls("video", seed=2, tokens_per_media_item=TPM)
    outs = []
    for b in range(n_pre + n_post):
        src = pre if b < n_pre else post
        if ctl.composer is not None:
            items = ctl.compose(draw=lambda: src.sample(gbs))
        else:
            items = src.sample(gbs)
        out = ctl.schedule(items)
        ctl.drain()          # a search set off by the shapes, before any feedback
        outs.append((out.groups, out.cmax, out.lower_bound, out.solver,
                     out.plan.as_tuple(), out.e_dur.tolist(), out.l_dur.tolist(),
                     [it.item_id for it in items]))
        # a deterministic "measurement": the residual grows after the shift
        # (the calibrator is fed with no search in flight: searches read it)
        ctl.observe_step(out, out.cmax * (1.1 if b < n_pre else 2.5), idle_s=0.01)
        ctl.observe("llm", float(out.l_dur.mean() * 100), float(out.l_dur.mean()),
                    float(out.l_dur.mean()) * 1.3, plan=out.plan)
        ctl.drain()
    ctl.close()
    snap = ctl.metrics.snapshot()
    for key in ("sched_elapsed_mean_s", "compose_elapsed_mean_s"):
        snap.pop(key)
    replans = [(dataclasses.astuple(r.trigger), r.stale_makespan, r.new_makespan,
                r.swapped, r.plan_tuple, r.gated, r.reshard) for r in ctl.replans]
    return dict(plan0=plan0, plan=ctl.plan.as_tuple(), outs=outs, replans=replans,
                drift=[dataclasses.astuple(e) for e in ctl.drift.events], snap=snap,
                trace=_trace_by_thread(ctl), calib=ctl.calibration.snapshot())


def eng_drift(eng):
    mod = drift if isinstance(eng, DFLOPEngine) else jdrift
    return mod.DriftDetector(window=64, ks_threshold=0.2, check_every=16, cooldown=32,
                             ph_burn_in=8)


@pytest.mark.parametrize("objective", ["mean", "balanced-quantile"])
def test_controller_replans_like_reference(objective):
    eng, jeng = _engines(objective)
    eng.plan(32)
    jeng.plan(32)
    got = _run_controller(eng, MixedDataset, 32, 3, 6)
    want = _run_controller(jeng, JMixedDataset, 32, 3, 6)
    assert got == want
    kinds = {d[0] for d in got["drift"]}
    assert "shape-ks" in kinds
    assert got["replans"] and got["replans"][0][0][0] == "shape-ks"
    assert any(r[3] for r in got["replans"]) and got["plan"] != got["plan0"]
    names = {e[1] for evs in got["trace"].values() for e in evs}
    assert {"schedule", "step", "replan-search", "plan-swap"} <= names


def test_controller_without_replan_matches_reference():
    eng, jeng = _engines()
    eng.plan(32)
    jeng.plan(32)
    got = _run_controller(eng, MixedDataset, 32, 2, 4, auto_replan=False)
    want = _run_controller(jeng, JMixedDataset, 32, 2, 4, auto_replan=False)
    assert got == want
    assert got["drift"] and not got["replans"] and got["plan"] == got["plan0"]


def test_controller_with_composer_matches_reference():
    """The lookahead composer attached through ``runtime(compose_window=)``:
    composed batches, the swap's window flush and the compose telemetry."""
    eng, jeng = _engines()
    eng.plan(16)
    jeng.plan(16)
    got = _run_controller(eng, MixedDataset, 16, 4, 8, compose_window=2)
    want = _run_controller(jeng, JMixedDataset, 16, 4, 8, compose_window=2)
    assert got == want
    assert got["snap"]["n_composed"] == 12
    names = {e[1] for evs in got["trace"].values() for e in evs}
    assert "compose" in names


def test_controller_maybe_swap_gates_like_reference():
    """A finished search that is not better by ``min_improvement`` is
    recorded, not adopted; the duck-typed swapper gates on amortization."""
    eng, _ = _engines()
    eng.plan(32)

    class Swapper:
        damaged = False

        def estimate_cost_s(self, old, new):
            return 1e9

        def swap(self, old, new):
            raise AssertionError("gated swaps must not run")

    ctl = eng.runtime(32, ilp_time_limit_s=0.0, param_swapper=Swapper(),
                      drift=eng_drift(eng))
    post = MixedDataset("video", seed=2, tokens_per_media_item=TPM)
    for _ in range(6):
        ctl.schedule(post.sample(32))
        ctl.drain()
    ctl.close()
    assert ctl.replans and all(not r.swapped for r in ctl.replans)
    assert {r.gated for r in ctl.replans} <= {"amortization", None}
    assert isinstance(ctl.replans[0], ReplanRecord)
    assert isinstance(ctl, RuntimeController) and ctl.metrics.n_physical_swaps == 0


# --------------------------------------------------------------------- #
# kernels/bench.py: measured kernel times into the calibrator
# --------------------------------------------------------------------- #
def _bench_rows(seed):
    """Rows as ``bench_kernel`` makes them, with injected times."""
    from repro.kernels import bench as jbench
    rng = np.random.default_rng(seed)
    rows = []
    for kernel, direction in itertools.product(("attention", "mamba", "rwkv6"),
                                               ("fwd", "fwdbwd")):
        for S in (256, 512, 1024, 3000):
            flops = jbench.attention_flops(1, 4, S, 64, causal=True) * (
                3.0 if direction == "fwdbwd" else 1.0)
            times = (rng.lognormal(-8, 0.3, 3) * S).tolist()
            rows.append({"kernel": kernel, "direction": direction, "tokens": S,
                         "bucket": jcal.shape_bucket(float(S)), "flops": flops,
                         "analytic_s": jbench.analytic_seconds(flops), "times_s": times,
                         "measured_s": float(sorted(times)[1])})
    rows[5]["measured_s"] = 0.0                           # skipped by the unit
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_bench_normalize_and_seed_calibrator_match_reference(seed):
    import copy

    from repro.kernels import bench as jbench
    from repro_torch.kernels import bench
    rows, jrows = _bench_rows(seed), _bench_rows(seed)
    assert bench.normalize(rows) == jbench.normalize(jrows)
    for module, tp in (("llm", 1), ("encoder", 2)):
        cal, jc = OnlineCalibrator(), jcal.OnlineCalibrator()
        assert bench.seed_calibrator(cal, copy.deepcopy(rows), module=module, tp=tp) == \
            jbench.seed_calibrator(jc, copy.deepcopy(jrows), module=module, tp=tp) > 0
        assert cal.snapshot() == jc.snapshot()
    # unnormalized rows have no unit: nothing is fed
    assert bench.seed_calibrator(OnlineCalibrator(), _bench_rows(seed)) == 0


@pytest.mark.parametrize("kernel,dims", [
    ("attention", dict(B=1, KH=2, G=2, D=32, causal=True)),
    ("attention", dict(B=2, KH=1, G=3, D=16, causal=False)),
    ("mamba", dict(B=1, di=32, N=16)),
    ("rwkv6", dict(B=1, H=1, M=32)),
])
def test_bench_kernel_rows_price_like_reference(kernel, dims):
    """``bench_kernel`` on the CPU (the kernels' plain versions): each row's
    bucket, work and analytic price are the reference's for the same case;
    the port prices with the H100 spec unless told otherwise."""
    from repro.kernels import bench as jbench
    from repro_torch.kernels import bench
    seqs = (24, 64)
    rows = bench.bench_kernel(kernel, seqs, iters=2, hw=an.V5E, dims=dims, device="cpu")
    h100 = bench.bench_kernel(kernel, seqs[:1], iters=1, dims=dims, device="cpu")
    assert [(r["tokens"], r["direction"]) for r in rows] == \
        [(S, d) for S in seqs for d in ("fwd", "fwdbwd")]
    count = {"attention": jbench.attention_flops, "mamba": jbench.mamba_flops,
             "rwkv6": jbench.rwkv6_flops}[kernel]
    for r in rows:
        kw = dict(dims, S=r["tokens"])
        args = ({k: kw[k] for k in ("B", "S", "D")} | {"H": kw["KH"] * kw["G"],
                                                       "causal": kw["causal"]}
                if kernel == "attention" else
                {k: kw[k] for k in (("B", "S", "di", "N") if kernel == "mamba"
                                    else ("B", "H", "S", "M"))})
        flops = count(**args) * (3.0 if r["direction"] == "fwdbwd" else 1.0)
        assert r["flops"] == flops
        assert r["bucket"] == jcal.shape_bucket(float(r["tokens"]))
        assert r["analytic_s"] == jbench.analytic_seconds(flops, jan.V5E)
        assert len(r["times_s"]) == 2 and all(t > 0 for t in r["times_s"])
        assert r["measured_s"] == sorted(r["times_s"])[1]
    assert h100[0]["analytic_s"] == h100[0]["flops"] / (an.H100.peak_flops
                                                        * an.H100.base_mxu_util)
