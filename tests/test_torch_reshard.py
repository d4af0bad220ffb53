"""The port's physical plan hot-swap (``launch/reshard.py``) and the
controller's swap gates against the reference, on the CPU, in one process.

The layout transforms, the cost model, measured bandwidth, the swapper's
gates and callbacks and ``maybe_swap`` with fake and real swappers run on
both packages with the same inputs (numpy, one seed); reports are held
equal to the reference's but for ``elapsed_s``.  The reference runs on its
one CPU device; the port on a process group of one gloo rank that this
file starts (``HashStore``) and destroys when it is done.  Meshes over
several ranks are in ``tests/test_torch_elastic.py``.
"""
import concurrent.futures
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.launch.reshard as jrs
from repro.common import types as jtypes
from repro.core.engine import DFLOPEngine as JEngine
from repro.core.optimizer import search as jsearch
from repro.core.optimizer import space as jspace
from repro.core.pipeline import executor as jexec
from repro.core.profiling import analytic as jan
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.runtime.drift import DriftEvent as JDriftEvent
import repro_torch.launch.reshard as rs
from repro_torch.common import types
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer import search, space
from repro_torch.core.pipeline import executor
from repro_torch.core.profiling import analytic as an
from repro_torch.data.synthetic import MixedDataset
from repro_torch.runtime.drift import DriftEvent

torch.set_num_threads(1)
CPU_PLAN = functools.partial(rs.plan_mesh, device_type="cpu")
CPU_CLAMPED = functools.partial(rs.clamped_plan_mesh, device_type="cpu")


@pytest.fixture(scope="module", autouse=True)
def group():
    """A process group of one gloo rank for this file's port meshes."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _plan(tp=1, pp=1, dp=1, n_mb=2):
    return space.ParallelismPlan(llm=space.ModuleParallelism(tp, pp, dp), n_mb=n_mb)


def _jplan(tp=1, pp=1, dp=1, n_mb=2):
    return jspace.ParallelismPlan(llm=jspace.ModuleParallelism(tp, pp, dp), n_mb=n_mb)


def _rep(r):
    """A report with its wall-clock field left out."""
    d = dataclasses.asdict(r)
    assert d.pop("elapsed_s") >= 0.0
    return d


def _arange(*shape):
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


# --------------------------------------------------------------------- #
# layout transforms
# --------------------------------------------------------------------- #
def test_stack_stage_params_generalized_restack():
    W = _arange(8, 3, 3)
    for p, from_p, src in ((4, None, W), (2, 4, "s4"), (1, None, W), (4, 1, "s1")):
        jt = jexec.stack_stage_params(jnp.asarray(W if src is W else jexec.stack_stage_params(
            jnp.asarray(W), int(src[1:]))), p, from_p=from_p)
        pt = executor.stack_stage_params(torch.tensor(W) if src is W else
                                         executor.stack_stage_params(torch.tensor(W),
                                                                     int(src[1:])),
                                         p, from_p=from_p)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(
        executor.unstack_stage_params(executor.stack_stage_params(torch.tensor(W), 4)).numpy(),
        W)
    with pytest.raises(ValueError, match="not divisible"):
        executor.stack_stage_params(torch.tensor(W), 3)


def test_plan_mesh_shape_and_device_shortfall():
    from repro_torch.launch.mesh import mesh_shape
    mesh = CPU_PLAN(_plan())
    assert mesh_shape(mesh) == dict(jrs.plan_mesh(_jplan()).shape) == \
        {"data": 1, "stage": 1, "model": 1}
    with pytest.raises(ValueError, match="needs 64 ranks, have 1"):
        CPU_PLAN(_plan(tp=8, pp=4, dp=2))
    with pytest.raises(ValueError, match="devices"):
        jrs.plan_mesh(_jplan(tp=8, pp=4, dp=2))
    clamped = CPU_CLAMPED(_plan(tp=8, pp=4, dp=2))
    assert mesh_shape(clamped) == dict(jrs.clamped_plan_mesh(_jplan(tp=8, pp=4, dp=2)).shape)
    # explicit ranks, as the fleet passes its roster
    assert mesh_shape(rs.clamped_plan_mesh(_plan(pp=4), ranks=[0], device_type="cpu")) == \
        {"data": 1, "stage": 1, "model": 1}


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rs.plan_mesh(_plan())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rs.ParamSwapper(lambda: {"w": torch.ones(2)}, lambda v: None).swap(_plan(), _plan())


def test_reshard_params_report_and_bytes():
    tree = {"w": np.ones((4, 8), np.float32), "b": np.zeros((8,), np.float32)}
    params = {k: torch.tensor(v) for k, v in tree.items()}
    keep = {k: v.clone() for k, v in params.items()}
    total = rs.param_bytes(params)
    new, rep = rs.reshard_params(params, _plan(), _plan(), mesh_factory=CPU_PLAN)
    jnew, jrep = jrs.reshard_params({k: jnp.asarray(v) for k, v in tree.items()},
                                    _jplan(), _jplan())
    assert _rep(rep) == _rep(jrep)
    assert rep.bytes_total == total == jrs.param_bytes(tree) == 160
    assert rep.bytes_moved == total and rep.n_leaves == 2 and not rep.restacked
    assert rep.old_plan == rep.new_plan == _plan().as_tuple()
    # placing again onto the SAME layout moves nothing
    _, rep2 = rs.reshard_params(new, _plan(), _plan(), mesh_factory=CPU_PLAN)
    _, jrep2 = jrs.reshard_params(jnew, _jplan(), _jplan())
    assert _rep(rep2) == _rep(jrep2) and rep2.bytes_moved == 0
    assert isinstance(new, rs.Placed) and new.spec == () and new.layout.ranks == (0,)
    torch.testing.assert_close(new.tree["w"], keep["w"], rtol=0, atol=0)
    # donation: the moved leaves left the input dict
    assert params == {"w": None, "b": None}


def test_reshard_params_autodetects_pp1_stacking():
    W = _arange(8, 3)
    new, rep = rs.reshard_params(executor.stack_stage_params(torch.tensor(W), 1),
                                 _plan(pp=1), _plan(pp=4), mesh_factory=CPU_CLAMPED)
    jnew, jrep = jrs.reshard_params(jexec.stack_stage_params(jnp.asarray(W), 1),
                                    _jplan(pp=1), _jplan(pp=4),
                                    mesh_factory=jrs.clamped_plan_mesh)
    assert _rep(rep) == _rep(jrep) and rep.restacked
    assert new.shapes == [tuple(jnew.shape)] == [(4, 2, 3)]
    assert new.spec == ("stage",)        # a stage axis of 1 divides 4
    np.testing.assert_array_equal(new.tree.numpy(), np.asarray(jnew))
    np.testing.assert_array_equal(executor.unstack_stage_params(new.tree).numpy(), W)


def test_reshard_params_restack_raises_on_non_divisible():
    with pytest.raises(ValueError, match="not divisible") as e:
        rs.reshard_params({"w": torch.ones(4, 2, 3)}, _plan(pp=4), _plan(pp=3),
                          stage_stacked=True, mesh_factory=CPU_PLAN)
    with pytest.raises(ValueError) as je:
        jrs.reshard_params({"w": jnp.ones((4, 2, 3))}, _jplan(pp=4), _jplan(pp=3),
                           stage_stacked=True)
    assert str(e.value) == str(je.value)


def test_estimate_reshard_s_linear_in_bytes():
    for n, kw in ((0, dict(latency_s=0.25)),
                  (10**11, dict(bandwidth_bytes_per_s=1e11, latency_s=0.0)),
                  (2 * 10**9, dict(bandwidth_bytes_per_s=1e11, latency_s=0.0))):
        assert rs.estimate_reshard_s(n, **kw) == jrs.estimate_reshard_s(n, **kw)
    assert rs.estimate_reshard_s(0, latency_s=0.25) == 0.25
    assert rs.estimate_reshard_s(10**11, bandwidth_bytes_per_s=1e11, latency_s=0.0) == 1.0
    # the default is the H100's NVLink 4 (450 GB/s each way), not a TPU's
    assert rs.DEFAULT_BANDWIDTH_BYTES_PER_S == 4.5e11
    assert rs.DEFAULT_LATENCY_S == jrs.DEFAULT_LATENCY_S


# --------------------------------------------------------------------- #
# ParamSwapper
# --------------------------------------------------------------------- #
def _swapper(params, **kw):
    live = {"p": params}
    kw.setdefault("mesh_factory", CPU_PLAN)
    return rs.ParamSwapper(lambda: live["p"], lambda v: live.update(p=v), **kw), live


def _jswapper(params, **kw):
    live = {"p": params}
    return jrs.ParamSwapper(lambda: live["p"], lambda v: live.update(p=v), **kw), live


def test_swapper_estimate_prefers_measured_bandwidth():
    sw, _ = _swapper({"w": torch.ones(64, 64)}, bandwidth_bytes_per_s=1.0, latency_s=0.0)
    jsw, _ = _jswapper({"w": jnp.ones((64, 64))}, bandwidth_bytes_per_s=1.0, latency_s=0.0)
    assert sw.estimate_cost_s(_plan(), _plan()) == jsw.estimate_cost_s(_jplan(), _jplan()) \
        == pytest.approx(64 * 64 * 4)
    rep, jrep = sw.swap(_plan(), _plan()), jsw.swap(_jplan(), _jplan())
    assert _rep(rep) == _rep(jrep)
    assert sw.reports == [rep] and rep.bytes_moved > 0
    measured = sw.estimate_cost_s(_plan(), _plan())
    assert 0.0 < measured < 10.0
    assert measured == pytest.approx(rep.bytes_total / (rep.bytes_moved / rep.elapsed_s))


def test_swapper_compatibility_gates():
    cases = [(dict(stage_stacked=True, mesh_factory=CPU_CLAMPED),
              dict(stage_stacked=True, mesh_factory=jrs.clamped_plan_mesh),
              [(dict(pp=4), dict(pp=2)), (dict(pp=4), dict(pp=3))]),
             (dict(), dict(), [(dict(), dict(tp=8, dp=4))]),
             (dict(stage_stacked=True, strict=False, mesh_factory=CPU_CLAMPED),
              dict(stage_stacked=True, strict=False, mesh_factory=jrs.clamped_plan_mesh),
              [(dict(pp=4), dict(pp=3))])]
    got = []
    for kw, jkw, transitions in cases:
        sw, _ = _swapper({"w": torch.ones(4, 2, 3)}, **kw)
        jsw, _ = _jswapper({"w": jnp.ones((4, 2, 3))}, **jkw)
        for a, b in transitions:
            ok = sw.compatible(_plan(**a), _plan(**b))
            assert ok == jsw.compatible(_jplan(**a), _jplan(**b))
            got.append(ok)
    assert got == [True, False, False, True]
    # non-strict (emulation) mode falls back to re-placement instead
    sw2, live2 = _swapper({"w": torch.ones(4, 2, 3)}, stage_stacked=True, strict=False,
                          mesh_factory=CPU_CLAMPED)
    jsw2, jlive2 = _jswapper({"w": jnp.ones((4, 2, 3))}, stage_stacked=True,
                             strict=False, mesh_factory=jrs.clamped_plan_mesh)
    rep, jrep = sw2.swap(_plan(pp=4), _plan(pp=3)), jsw2.swap(_jplan(pp=4), _jplan(pp=3))
    assert _rep(rep) == _rep(jrep) and not rep.restacked and rep.bytes_moved > 0
    assert live2["p"].shapes == [tuple(jlive2["p"]["w"].shape)] == [(4, 2, 3)]


def test_swapper_updates_live_params_via_callbacks():
    W = _arange(8, 3)
    sw, live = _swapper(executor.stack_stage_params(torch.tensor(W), 4),
                        stage_stacked=True, mesh_factory=CPU_CLAMPED)
    jsw, jlive = _jswapper(jexec.stack_stage_params(jnp.asarray(W), 4), stage_stacked=True,
                           mesh_factory=jrs.clamped_plan_mesh)
    rep, jrep = sw.swap(_plan(pp=4), _plan(pp=2)), jsw.swap(_jplan(pp=4), _jplan(pp=2))
    assert _rep(rep) == _rep(jrep) and rep.restacked
    assert live["p"].shapes == [tuple(jlive["p"].shape)] == [(2, 4, 3)]
    np.testing.assert_array_equal(live["p"].tree.numpy(), np.asarray(jlive["p"]))
    np.testing.assert_array_equal(executor.unstack_stage_params(live["p"].tree).numpy(), W)


def test_swapper_keeps_trainable_leaves_and_step_count():
    """A swap of (params, AdamW state): leaves that required grad still do,
    as leaves; the non-tensor step count comes along; nothing else is
    copied; ``state[0]`` is the placed params."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g).requires_grad_(True),
              "layers": [{"b": torch.randn(5, generator=g).requires_grad_(True)}]}
    opt = {"m": {"w": torch.zeros(3, 4), "layers": [{"b": torch.ones(5)}]},
           "v": {"w": torch.ones(3, 4), "layers": [{"b": torch.zeros(5)}]}, "step": 7}
    want = [a.detach().clone() for a in [params["layers"][0]["b"], params["w"]]]
    sw, live = _swapper((params, opt))
    rep = sw.swap(_plan(), _plan(n_mb=4))
    assert rep.n_leaves == 7 and rep.bytes_total == rep.bytes_moved == 4 * (12 + 5) * 3
    p, o = live["p"].tree
    assert o["step"] == 7 and live["p"][1].tree["step"] == 7
    assert p["w"].requires_grad and p["w"].is_leaf and not o["m"]["w"].requires_grad
    assert [torch.equal(a, b) for a, b in zip([p["layers"][0]["b"], p["w"]], want)] == [True] * 2
    assert live["p"][0].shapes == [(5,), (3, 4)] and live["p"].local_bytes() == rep.bytes_total
    assert live["p"].with_tree((p, o)).tree[1]["step"] == 7
    with pytest.raises(ValueError, match="leaves"):
        live["p"].with_tree(p)


def test_failed_swap_after_a_release_is_damaged(monkeypatch):
    """A swap that fails once it has released an old leaf leaves the
    swapper ``damaged`` (the controller then fails fast); one that fails
    first, or that does not donate, does not."""
    real = rs._gather
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("link down")
        return real(*a, **kw)

    monkeypatch.setattr(rs, "_gather", flaky)
    sw, live = _swapper({"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(RuntimeError, match="link down"):
        sw.swap(_plan(), _plan())
    assert sw.damaged and live["p"]["a"] is None          # released, then lost
    calls.clear()
    calls.append(1)                                        # fail on the first leaf
    sw2, live2 = _swapper({"a": torch.ones(2), "b": torch.ones(3)})
    with pytest.raises(RuntimeError, match="link down"):
        sw2.swap(_plan(), _plan())
    assert not sw2.damaged and live2["p"]["a"] is not None
    calls.clear()
    sw3, live3 = _swapper({"a": torch.ones(2), "b": torch.ones(3)}, donate=False)
    with pytest.raises(RuntimeError, match="link down"):
        sw3.swap(_plan(), _plan())
    assert not sw3.damaged and all(v is not None for v in live3["p"].values())


# --------------------------------------------------------------------- #
# controller integration: amortized gate + physical swap + found-guard
# --------------------------------------------------------------------- #
def _controller(swapper=None, horizon=50, ref=False):
    T = (jtypes, jspace, JEngine, JMixedDataset, jan) if ref else \
        (types, space, DFLOPEngine, MixedDataset, an)
    llm = T[0].ModelConfig(name="l", family="dense", n_layers=8, d_model=256,
                           n_heads=4, n_kv_heads=4, d_ff=1024, vocab_size=512)
    eng = T[2](llm_cfg=llm, cluster=T[1].ClusterSpec(n_chips=4, chips_per_node=4),
               backend=T[4].AnalyticBackend(T[4].V5E))
    eng.profile(T[3]("single_image", seed=0, tokens_per_media_item=64))
    eng.plan(8)
    return eng.runtime(8, adaptive=False, auto_replan=False, calibrate=False,
                       ilp_time_limit_s=0.0, param_swapper=swapper,
                       swap_horizon_batches=horizon)


def _inject_result(ctl, res, stale, ref=False):
    fut = concurrent.futures.Future()
    event = (JDriftEvent if ref else DriftEvent)("shape-ks", 0.5, 0.2, 8)
    fut.set_result((event, ctl.engine.dist, res, stale))
    ctl._replan_future = fut


def _result(plan_kw, makespan, ref=False):
    if plan_kw is None:
        return (jsearch if ref else search).SearchResult(None, float("nan"), 5, 0, 0.01)
    return (jsearch if ref else search).SearchResult(
        (_jplan if ref else _plan)(**plan_kw), makespan, 5, 5, 0.01)


def _outcome(ctl, swapped):
    r = ctl.replans[-1]
    snap = ctl.metrics.snapshot()
    names = sorted({e[1] for e in ctl.trace._events})
    return dict(swapped=swapped, plan=ctl.plan.as_tuple(), new_makespan=r.new_makespan,
                rec_swapped=r.swapped, plan_tuple=r.plan_tuple, gated=r.gated,
                reshard=None if r.reshard is None else _rep(r.reshard),
                n_replans=snap["n_replans"], n_physical_swaps=snap["n_physical_swaps"],
                names=names)


def _gate_case(make_swapper, plan_kw, makespan, stale, horizon=50):
    out = []
    for ref in (False, True):
        ctl = _controller(make_swapper(ref), horizon, ref=ref)
        _inject_result(ctl, _result(plan_kw, makespan, ref), stale, ref)
        out.append(_outcome(ctl, ctl.maybe_swap()))
        ctl.close()
    assert out[0] == out[1]
    return out[0]


def test_maybe_swap_guards_not_found_search():
    got = _gate_case(lambda ref: None, None, None, 1.25)
    assert got["swapped"] is False and got["new_makespan"] == float("inf")
    assert not got["rec_swapped"] and got["plan_tuple"] is None and got["gated"] is None


def _real(ref, shape, **kw):
    if ref:
        return _jswapper({"w": jnp.ones(shape)}, **kw)[0]
    return _swapper({"w": torch.ones(shape)}, **kw)[0]


def test_maybe_swap_physical_swap_records_reshard():
    got = _gate_case(lambda ref: _real(ref, (256, 256), latency_s=0.0), dict(n_mb=4), 0.5,
                     1.0)
    assert got["swapped"] and got["plan"] == _plan(n_mb=4).as_tuple()
    assert got["n_physical_swaps"] == got["n_replans"] == 1
    assert got["rec_swapped"] and got["reshard"]["bytes_moved"] == 256 * 256 * 4
    assert {"reshard", "plan-swap", "reshard_s"} <= set(got["names"])


def test_maybe_swap_gates_on_amortized_reshard_cost():
    got = _gate_case(lambda ref: _real(ref, (8, 8), latency_s=1e9), dict(n_mb=4), 0.5, 1.0)
    assert got["swapped"] is False and got["n_replans"] == got["n_physical_swaps"] == 0
    assert got["gated"] == "amortization" and not got["rec_swapped"]
    assert got["plan_tuple"] is not None and "swap-gated" in got["names"]


def test_maybe_swap_gates_on_incompatible_transition():
    got = _gate_case(lambda ref: _real(ref, (4, 2, 3), stage_stacked=True, latency_s=0.0),
                     dict(pp=3), 0.5, 1.0)
    assert got["swapped"] is False and got["gated"] == "incompatible"


class _FailingSwapper:
    def __init__(self, damage: bool):
        self._damage, self.damaged = damage, False

    def swap(self, old_plan, new_plan):
        self.damaged = self._damage
        raise RuntimeError("transfer blew up")


def test_maybe_swap_recovers_from_non_destructive_reshard_failure():
    got = _gate_case(lambda ref: _FailingSwapper(False), dict(n_mb=4), 0.5, 1.0)
    assert got["swapped"] is False and got["gated"] == "reshard-error"
    assert "reshard-error" in got["names"] and "reshard" not in got["names"]


def test_maybe_swap_fails_fast_when_donation_consumed_live_buffers():
    for ref in (False, True):
        ctl = _controller(_FailingSwapper(True), ref=ref)
        _inject_result(ctl, _result(dict(n_mb=4), 0.5, ref), 1.0, ref)
        with pytest.raises(RuntimeError, match="transfer blew up"):
            ctl.maybe_swap()
        ctl.close()


def test_submit_defers_physical_swap_to_explicit_boundary():
    out = []
    for ref in (False, True):
        ctl = _controller(_real(ref, (8, 8), latency_s=0.0), ref=ref)
        _inject_result(ctl, _result(dict(n_mb=4), 0.5, ref), 1.0, ref)
        items = (JMixedDataset if ref else MixedDataset)(
            "single_image", seed=0, tokens_per_media_item=64).sample(8)
        ctl.submit(items)
        row = [ctl.metrics.n_physical_swaps, ctl.plan.as_tuple()]
        got = ctl.collect()
        row += [got.groups, ctl.maybe_swap(), ctl.metrics.n_physical_swaps,
                ctl.plan.as_tuple()]
        ctl.close()
        out.append(row)
    assert out[0] == out[1]
    assert out[0][0] == 0 and out[0][1] != _plan(n_mb=4).as_tuple()
    assert out[0][3] is True and out[0][4] == 1 and out[0][5] == _plan(n_mb=4).as_tuple()


def test_maybe_swap_without_swapper_is_logical_only():
    got = _gate_case(lambda ref: None, dict(n_mb=4), 0.5, 1.0)
    assert got["swapped"] and got["n_physical_swaps"] == 0
    assert got["plan"] == _plan(n_mb=4).as_tuple()
