"""The port's fleet membership (``launch/fleet.py``), host-sharded source
(``data/host_shard.py``) and the controller's roster recovery against the
reference, on the CPU, in one process.

Each case runs the same scenario through both packages and holds the port's
results *equal* to the reference's: rosters, membership events, cluster
specs, committed batches, plan tuples, groups, ``RecoveryRecord``s (but
their ``elapsed_s``) and metrics snapshots (but the means of wall-clock
readings); and it keeps the reference test's own assertions
(``tests/test_fleet.py``).  Roster-only cases use opaque labels as
devices, as the reference's do; meshes over real ranks are in
``tests/test_torch_elastic.py``.

Both engines price with the reference's V5E spec (the port's default is the
H100) and schedule with a time limit of 0, so the branch-and-bound stops at
its 1024th node on both sides alike.
"""
import concurrent.futures
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.optimizer.search as jsearch
import repro.core.optimizer.space as jspace
import repro.core.profiling.analytic as jan
import repro.data.host_shard as jhost
import repro.data.synthetic as jsyn
import repro.launch.fleet as jfleet
import repro.runtime.controller as jctl
import repro.runtime.drift as jdrift
from repro.common import types as jtypes
from repro.core.engine import DFLOPEngine as JEngine
import repro_torch.core.optimizer.search as search
import repro_torch.core.optimizer.space as space
import repro_torch.core.profiling.analytic as an
import repro_torch.data.host_shard as host
import repro_torch.data.synthetic as syn
import repro_torch.launch.fleet as fleet
import repro_torch.runtime.controller as ctl_mod
import repro_torch.runtime.drift as drift
from repro_torch.common import types
from repro_torch.core.engine import DFLOPEngine

torch.set_num_threads(1)

SIDES = {
    "port": SimpleNamespace(fleet=fleet, host=host, space=space, search=search,
                            syn=syn, ctl=ctl_mod, drift=drift, types=types,
                            Engine=DFLOPEngine, V5E=an.AnalyticBackend(an.V5E)),
    "ref": SimpleNamespace(fleet=jfleet, host=jhost, space=jspace, search=jsearch,
                           syn=jsyn, ctl=jctl, drift=jdrift, types=jtypes,
                           Engine=JEngine, V5E=jan.AnalyticBackend(jan.V5E)),
}
# the metrics that average wall-clock readings
CLOCK_KEYS = ("sched_elapsed_mean_s", "compose_elapsed_mean_s", "reshard_mean_s")


def both(scenario, *args):
    """``scenario(side, *args)`` on the port and the reference: equal."""
    got, want = scenario(SIDES["port"], *args), scenario(SIDES["ref"], *args)
    assert got == want
    return got


def _plan(S, tp=1, pp=1, dp=1, n_mb=2):
    return S.space.ParallelismPlan(llm=S.space.ModuleParallelism(tp, pp, dp), n_mb=n_mb)


def _raises(fn, exc):
    with pytest.raises(exc) as e:
        fn()
    return f"{type(e.value).__name__}: {e.value}"


# --------------------------------------------------------------------- #
# FleetManager roster lifecycle
# --------------------------------------------------------------------- #
def _lifecycle(S):
    F = S.fleet
    fm = F.FleetManager(devices=list("abcdefgh"), devices_per_host=2)
    rec = [(fm.n_hosts, fm.n_alive, fm.n_chips, fm.devices())]
    ev = fm.fail(1, step=5)
    assert ev == F.MembershipEvent("fail", 1, 5, 3)
    rec.append((dataclasses.astuple(ev), fm.alive_ids(), fm.devices(), fm.n_chips))
    fm.leave(3)
    rec.append((fm.n_chips, [dataclasses.astuple(e) for e in fm.poll_events()],
                fm.poll_events()))
    fm.join(1)
    rec.append((fm.n_chips, [dataclasses.astuple(e) for e in fm.history]))
    rec.append(_raises(lambda: fm.fail(3), ValueError))
    rec.append(_raises(lambda: fm.join(0), ValueError))
    rec.append(_raises(lambda: fm.host(99), KeyError))
    return rec


def test_fleet_roster_lifecycle():
    rec = both(_lifecycle)
    assert rec[0] == (4, 4, 8, list("abcdefgh"))
    assert rec[1][1:] == ([0, 2, 3], list("abefgh"), 6)
    assert rec[2] == (4, [("fail", 1, 5, 3), ("leave", 3, -1, 2)], [])
    assert rec[3][0] == 6 and [e[0] for e in rec[3][1]] == ["fail", "leave", "join"]
    assert "already down" in rec[4] and "already alive" in rec[5]


def _validation(S):
    F = S.fleet
    fm = F.FleetManager(devices=list("abcd"), n_hosts=2)
    return [_raises(lambda: F.FleetManager(devices=list("abc"), devices_per_host=2),
                    ValueError),
            _raises(lambda: F.FleetManager(devices=list("abcd"), n_hosts=3), ValueError),
            (fm.devices_per_host, fm.n_hosts)]


def test_fleet_constructor_validation():
    rec = both(_validation)
    assert "do not split" in rec[0] and "do not split" in rec[1] and rec[2] == (2, 2)
    # the port's devices are the process group's ranks: none, so it raises
    # (the reference takes jax.devices()); it never falls back to one rank
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        fleet.FleetManager(n_hosts=2)


def _cluster_spec(S, template_kw):
    fm = S.fleet.FleetManager(devices=list(range(8)), devices_per_host=2)
    template = S.space.ClusterSpec(**template_kw)
    out = [dataclasses.astuple(fm.cluster_spec(template))]
    fm.fail(0)
    out += [dataclasses.astuple(fm.cluster_spec(template)),
            dataclasses.astuple(fm.cluster_spec())]
    return out


@pytest.mark.parametrize("template_kw", [
    dict(n_chips=256, chips_per_node=16, mem_bytes=int(16e9), name="pod"),
    # the trainer's cluster: 16 H100s of 80 GB in one node
    dict(n_chips=16, chips_per_node=16, mem_bytes=an.H100.mem_bytes, name="h100-node")],
    ids=["pod", "h100"])
def test_fleet_cluster_spec_tracks_roster(template_kw):
    out = both(_cluster_spec, template_kw)
    assert out[0][:2] == (8, 2) and out[0][2:] == (template_kw["mem_bytes"],
                                                   template_kw["name"])
    assert out[1][0] == 6 and out[2][:2] == (6, 2)


def test_largest_divisor_leq_properties():
    for n in range(1, 33):
        for limit in range(1, 33):
            d = fleet.largest_divisor_leq(n, limit)
            assert d == jfleet.largest_divisor_leq(n, limit)
            assert n % d == 0 and 1 <= d <= max(limit, 1)
            assert not any(n % k == 0 for k in range(d + 1, min(n, limit) + 1))


# --------------------------------------------------------------------- #
# FaultInjector
# --------------------------------------------------------------------- #
def _injector(S):
    fm = S.fleet.FleetManager(devices=list("abcd"), devices_per_host=1)
    inj = S.fleet.FaultInjector(fm, {1: [("fail", 3), ("leave", 2)], 4: [("join", 3)]})
    per_step = [[dataclasses.astuple(e) for e in inj.on_step(k)] for k in range(6)]
    return per_step, fm.alive_ids(), [dataclasses.astuple(e) for e in inj.fired]


def test_fault_injector_fires_deterministic_schedule():
    per_step, alive, fired = both(_injector)
    assert [len(s) for s in per_step] == [0, 2, 0, 0, 1, 0]
    assert [e[0] for e in fired] == ["fail", "leave", "join"]
    assert all(e[2] in (1, 4) for e in fired) and alive == [0, 1, 3]


def test_fault_injector_rejects_unknown_action():
    msgs = both(lambda S: _raises(lambda: S.fleet.FaultInjector(
        S.fleet.FleetManager(devices=list("ab")), {0: [("explode", 0)]}), ValueError))
    assert "unknown action" in msgs


# --------------------------------------------------------------------- #
# per-host data sharding: exactly-once under churn
# --------------------------------------------------------------------- #
def _partition(S):
    items = list(range(10))
    out = [S.host.partition_by_host(items, r) for r in ([0, 2, 5], [0], [1, 2], [3, 1, 4, 0])]
    return out, _raises(lambda: S.host.partition_by_host(items, []), ValueError)


def test_partition_by_host_roundrobin_union():
    shards, err = both(_partition)
    assert shards[0] == {0: [0, 3, 6, 9], 2: [1, 4, 7], 5: [2, 5, 8]}
    for sh in shards:
        assert sorted(x for s in sh.values() for x in s) == list(range(10))
    assert "empty roster" in err
    np.testing.assert_equal(host.partition_by_host([], [1]), {1: []})


def _step_contract(S):
    H = S.host.HostShardedSource
    src = H(iter([[0, 1, 2, 3]] * 4).__next__, gbs=4)
    out = [_raises(src.commit, RuntimeError), _raises(src.abort, RuntimeError),
           src.draw([0]), _raises(lambda: src.draw([0]), RuntimeError)]
    src.commit()
    out += [_raises(src.draw, ValueError),
            _raises(lambda: H(lambda: [], gbs=2).draw([0]), RuntimeError),
            _raises(lambda: H(lambda: [0], gbs=0), ValueError)]
    return out


def test_host_sharded_source_step_contract():
    out = both(_step_contract)
    assert "no step in flight" in out[0] and "no step in flight" in out[1]
    assert out[2] == {0: [0, 1, 2, 3]} and "in flight" in out[3]
    assert "no fleet" in out[4] and "exhausted" in out[5] and "gbs" in out[6]


def _churn(S, gbs=8, n_steps=40):
    def make_stream():
        c = iter(range(10_000))
        return lambda: [next(c) for _ in range(gbs)]

    ref = S.host.HostShardedSource(make_stream(), gbs=gbs)
    for _ in range(n_steps):
        ref.draw([0])
        ref.commit()
    rng = np.random.default_rng(7)
    fm = S.fleet.FleetManager(devices=list(range(8)), devices_per_host=2)
    src = S.host.HostShardedSource(make_stream(), gbs=gbs, fleet=fm)
    shard_log = []
    while src.n_committed < n_steps:
        shards = src.draw()
        assert sorted(x for s in shards.values() for x in s) == sorted(src.in_flight)
        assert set(shards) == set(fm.alive_ids())
        shard_log.append(shards)
        if rng.random() < 0.3 and fm.n_alive > 1:
            fm.fail(fm.alive_ids()[int(rng.integers(fm.n_alive))])
            src.abort()
        else:
            src.commit()
        if fm.n_alive < fm.n_hosts and rng.random() < 0.4:
            fm.join([h.host_id for h in fm.hosts if not h.alive][0])
    return (src.committed, ref.committed, src.n_aborted, src.n_drawn, shard_log,
            [dataclasses.astuple(e) for e in fm.history])


def test_host_sharded_source_exactly_once_under_churn():
    committed, fault_free, n_aborted, _, _, _ = both(_churn)
    assert n_aborted > 0, "churn schedule never fired a failure"
    assert committed == fault_free
    ids = [x for b in committed for x in b]
    assert len(ids) == len(set(ids)) == 8 * 40


def _loss_trajectory(S, gbs=8, n_steps=12):
    def emu_loss(batch):
        return float(sum(it.text_len + 31 * it.n_media_items for it in batch))

    ds = S.syn.MixedDataset("mixed", seed=11, tokens_per_media_item=64)
    ref_src = S.host.HostShardedSource(lambda: ds.sample(gbs), gbs=gbs)
    ref_losses = []
    for _ in range(n_steps):
        ref_src.draw([0])
        ref_losses.append(emu_loss(ref_src.in_flight))
        ref_src.commit()
    ds2 = S.syn.MixedDataset("mixed", seed=11, tokens_per_media_item=64)
    fm = S.fleet.FleetManager(devices=list(range(4)), devices_per_host=1)
    src = S.host.HostShardedSource(lambda: ds2.sample(gbs), gbs=gbs, fleet=fm)
    inj = S.fleet.FaultInjector(fm, {3: [("fail", 2)], 7: [("join", 2)], 9: [("fail", 1)]})
    losses, k = [], 0
    while len(losses) < n_steps:
        src.draw()
        mid_step = inj.on_step(k)
        k += 1
        if any(e.kind == "fail" for e in mid_step):
            src.abort()
            continue
        losses.append(emu_loss(src.in_flight))
        src.commit()
    return losses, ref_losses, src.n_aborted


def test_fleet_loss_trajectory_continuity_under_churn():
    losses, ref_losses, n_aborted = both(_loss_trajectory)
    assert n_aborted == 2 and losses == ref_losses


# --------------------------------------------------------------------- #
# the scheduler's roster check and the controller's recovery
# --------------------------------------------------------------------- #
def _tiny_engine(S, n_chips=4):
    llm = S.types.ModelConfig(name="l", family="dense", n_layers=8, d_model=256,
                              n_heads=4, n_kv_heads=4, d_ff=1024, vocab_size=512)
    eng = S.Engine(llm_cfg=llm, cluster=S.space.ClusterSpec(n_chips=n_chips,
                                                             chips_per_node=n_chips),
                   backend=S.V5E)
    eng.profile(S.syn.MixedDataset("single_image", seed=0, tokens_per_media_item=64))
    eng.plan(8)
    return eng


def _roster_check(S):
    sched = _tiny_engine(S).scheduler(plan=_plan(S, dp=4))
    sched.set_roster(3)
    err = _raises(lambda: sched.set_plan(_plan(S, dp=4)), ValueError)
    sched.set_plan(_plan(S, dp=3))
    dp = sched.plan.llm.dp
    sched.set_roster(None)
    sched.set_plan(_plan(S, dp=4))
    return err, dp, sched.plan.as_tuple()


def test_scheduler_set_plan_validates_roster():
    err, dp, final = both(_roster_check)
    assert "roster" in err and dp == 3 and final[5] == 4


def _fleet_controller(S, n_hosts=4, swapper=None):
    eng = _tiny_engine(S, n_chips=n_hosts)
    fm = S.fleet.FleetManager(devices=list(range(n_hosts)), devices_per_host=1)
    ctl = eng.runtime(8, adaptive=False, auto_replan=False, calibrate=False, trace=False,
                      ilp_time_limit_s=0.0, param_swapper=swapper, fleet=fm)
    return ctl, fm


def _record(r):
    """A RecoveryRecord with its wall-clock field left out."""
    d = dataclasses.asdict(r)
    d.pop("elapsed_s")
    d["reshard"] = None if r.reshard is None else dataclasses.astuple(r.reshard)
    return d


def _snap(ctl):
    snap = ctl.metrics.snapshot()
    for key in CLOCK_KEYS:
        snap.pop(key)
    snap["fleet"].pop("recovery_mean_s")
    return snap


def _out(out):
    return out.plan.as_tuple(), out.groups, out.cmax, out.solver


def _survivors_and_rejoin(S):
    ctl, fm = _fleet_controller(S)
    ds = S.syn.MixedDataset("single_image", seed=0, tokens_per_media_item=64)
    outs = [(_out(ctl.schedule(ds.sample(8))), ctl.scheduler.roster_chips)]
    fm.fail(3, step=1)
    outs.append((_out(ctl.schedule(ds.sample(8))), ctl.scheduler.roster_chips))
    fm.join(3, step=2)
    outs.append((_out(ctl.schedule(ds.sample(8))), ctl.scheduler.roster_chips))
    recovery_mean = ctl.metrics.snapshot()["fleet"]["recovery_mean_s"]
    ctl.close()
    return outs, [_record(r) for r in ctl.recoveries], _snap(ctl), recovery_mean is None


def test_controller_recovery_replans_for_survivors_and_rejoin():
    outs, recs, snap, no_mean = both(_survivors_and_rejoin)
    assert outs[0][1] == 4 and outs[0][0][0][5] * outs[0][0][0][3] * outs[0][0][0][4] == 4
    assert outs[1][1] == 3 and recs[0]["adopted"] and not recs[0]["degraded"]
    assert recs[0]["error"] is None and recs[0]["n_chips"] == 3
    assert recs[0]["events"][0]["kind"] == "fail"
    assert outs[2][1] == 4 and recs[1]["n_chips"] == 4
    fl = snap["fleet"]
    assert (fl["n_host_failures"], fl["n_host_joins"], fl["n_recoveries"],
            fl["n_degraded"]) == (1, 1, 2, 0)
    assert not no_mean


def _coalesce(S):
    ctl, fm = _fleet_controller(S)
    fm.fail(1)
    fm.fail(2)
    out = _out(ctl.schedule(S.syn.MixedDataset(
        "single_image", seed=0, tokens_per_media_item=64).sample(8)))
    ctl.close()
    return out, [_record(r) for r in ctl.recoveries], ctl.plan.chips


def test_controller_recovery_coalesces_simultaneous_events():
    _, recs, chips = both(_coalesce)
    assert len(recs) == 1 and len(recs[0]["events"]) == 2
    assert recs[0]["n_chips"] == 2 and chips <= 2


class _Boom:
    def __init__(self, *a, **kw):
        raise RuntimeError("search backend down")


def _search_fails(S, monkeypatch):
    ctl, fm = _fleet_controller(S)
    old = ctl.plan
    monkeypatch.setattr(S.ctl, "ParallelismOptimizer", _Boom)
    fm.fail(3)
    out = _out(ctl.schedule(S.syn.MixedDataset(
        "single_image", seed=0, tokens_per_media_item=64).sample(8)))
    ctl.close()
    return out, [_record(r) for r in ctl.recoveries], ctl.plan is old, _snap(ctl)


def test_controller_recovery_degrades_when_search_fails(monkeypatch):
    _, recs, kept, snap = both(_search_fails, monkeypatch)
    assert not recs[-1]["adopted"] and recs[-1]["degraded"]
    assert "search backend down" in recs[-1]["error"] and kept
    assert snap["fleet"]["n_degraded"] == 1


class _FailingSwapper:
    """swap() and refresh() both fail; `damaged` says whether the controller
    must fail fast or degrade (the reference test's)."""

    def __init__(self, damage):
        self.damaged_after, self.damaged, self.calls = damage, False, []

    def swap(self, old, new):
        self.calls.append(("swap", old.as_tuple(), new.as_tuple()))
        self.damaged = self.damaged_after
        raise RuntimeError("transfer failed")

    def refresh(self, plan):
        self.calls.append(("refresh", plan.as_tuple()))
        self.damaged = self.damaged_after
        raise RuntimeError("transfer failed")


def _reshard_fails(S):
    sw = _FailingSwapper(damage=False)
    ctl, fm = _fleet_controller(S, swapper=sw)
    old = ctl.plan
    fm.fail(3)
    ctl.schedule(S.syn.MixedDataset("single_image", seed=0,
                                    tokens_per_media_item=64).sample(8))
    ctl.close()
    return [_record(r) for r in ctl.recoveries], ctl.plan is old, sw.calls


def test_controller_recovery_reshard_failure_falls_back_to_stale_layout():
    recs, kept, calls = both(_reshard_fails)
    assert not recs[-1]["adopted"] and recs[-1]["degraded"]
    assert recs[-1]["reshard"] is None and "transfer failed" in recs[-1]["error"]
    assert kept and [c[0] for c in calls] in (["swap", "refresh"], ["refresh"])


def _damaged(S):
    ctl, fm = _fleet_controller(S, swapper=_FailingSwapper(damage=True))
    fm.fail(3)
    msg = _raises(lambda: ctl.schedule(S.syn.MixedDataset(
        "single_image", seed=0, tokens_per_media_item=64).sample(8)), RuntimeError)
    ctl.close()
    return msg


def test_controller_recovery_raises_when_swapper_damaged():
    assert "transfer failed" in both(_damaged)


def _raced(S):
    ctl, fm = _fleet_controller(S)
    fm.fail(3)
    ctl.poll_fleet()
    big = S.space.ParallelismPlan(llm=S.space.ModuleParallelism(1, 1, 4), n_mb=2)
    fut = concurrent.futures.Future()
    fut.set_result((S.drift.DriftEvent("shape-ks", 0.5, 0.2, 8), ctl.engine.dist,
                    S.search.SearchResult(big, 1e-9, 5, 5, 0.01), 1e9))
    ctl._replan_future = fut
    swapped = ctl.maybe_swap()
    ctl.close()
    r = ctl.replans[-1]
    return swapped, r.gated, r.plan_tuple, ctl.plan.as_tuple(), ctl.plan.chips


def test_maybe_swap_gates_plan_raced_by_roster_shrink():
    swapped, gated, _, _, chips = both(_raced)
    assert swapped is False and gated == "roster" and chips <= 3


# --------------------------------------------------------------------- #
# differential: fleet vs single-host, no fault -> identical decisions
# --------------------------------------------------------------------- #
def _no_fault(S):
    ds_a = S.syn.MixedDataset("mixed", seed=3, tokens_per_media_item=64)
    ds_b = S.syn.MixedDataset("mixed", seed=3, tokens_per_media_item=64)
    kw = dict(adaptive=False, auto_replan=False, calibrate=False, trace=False,
              ilp_time_limit_s=0.0)
    ctl_a = _tiny_engine(S).runtime(8, **kw)
    fm = S.fleet.FleetManager(devices=list(range(4)), devices_per_host=1)
    ctl_b = _tiny_engine(S).runtime(8, fleet=fm, **kw)
    src = S.host.HostShardedSource(lambda: ds_b.sample(8), gbs=8, fleet=fm)
    inj = S.fleet.FaultInjector(fm, {})
    outs = []
    for k in range(6):
        items_a = ds_a.sample(8)
        inj.on_step(k)
        src.draw()
        items_b = src.in_flight
        assert [it.item_id for it in items_b] == [it.item_id for it in items_a]
        out_a, out_b = ctl_a.schedule(items_a), ctl_b.schedule(items_b)
        src.commit()
        assert _out(out_a)[:2] == _out(out_b)[:2]
        assert out_b.cmax == pytest.approx(out_a.cmax)
        outs.append((_out(out_a), _out(out_b), [it.item_id for it in items_b]))
    assert ctl_b.recoveries == [] and inj.fired == []
    ctl_a.close()
    ctl_b.close()
    return outs


def test_fleet_matches_single_host_when_no_fault_fires():
    outs = both(_no_fault)
    assert len(outs) == 6
