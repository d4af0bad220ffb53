"""Elastic execution on 4 gloo ranks against the reference at 4 forced host
devices: the physical reshard, the fleet's meshes and checkpoint-free
migration, and ``train_mllm --hosts``.

One pool of processes serves the whole file, started together: the
reference in a subprocess (its device count is fixed at jax's first init),
4 single-threaded gloo ranks of the port on a ``FileStore`` (``python
tests/test_torch_elastic.py rank ...``), each writing an ``.npz``, and 4
ranks of ``python -m repro_torch.train_mllm --tiny --device cpu --steps 8
--hosts 4 --fail-host-at 3 --revive-host-at 6`` on ``env://`` (what
``torch.distributed.run`` gives them); meanwhile the pytest process runs
the trainer alone (a world of 1) for 24 steps over a data shift with
re-planning.  No process group outlives a test.  Run alone (~1.5 min):
``PYTHONPATH=src python -m pytest -q tests/test_torch_elastic.py``.

Inputs come from one numpy seed.  Layers are 8 of d 16 in two kinds:
``tanh(h @ w)``, and an exact one, ``relu(h @ w) - h / 2`` with ``w`` a
signed permutation and ``h`` in quarters, whose every result is exact in
fp32, so that the port's outputs can be held bitwise to the reference's.

Cases:
  * ``reshard_params`` over (dp, pp, tp) (1,4,1) -> (2,2,1) -> (1,2,2) ->
    (1,1,4) -> (4,1,1) -> (1,4,1), then PP 8 on a clamped 4-rank mesh:
    after each, ``pipeline_forward`` on the new mesh over the placed state,
    bitwise equal to the first output on every rank of the mesh (both
    layers) and to the reference's (the exact layer bitwise, tanh within
    1e-6); each ``ReshardReport`` equal to the reference's but for
    ``elapsed_s``; each rank holds exactly its block;
  * PP 3 on a 2-wide clamped stage axis is replicated, on ranks 0 and 1
    only;
  * ``fleet_plan_mesh``'s divisor clamp (stage 2 on 3 survivors, where the
    clamped mesh has 3 and replicates), the fleet's reshard keeping stage
    sharding on the shrunken roster, and the pp=1 auto-detection through
    the fleet factory;
  * the fleet's N -> N-1 -> N transition with rank 0 failing under a PP 2
    plan (half the fleet): pipeline outputs and the optimizer state exact
    across ``refresh``, the failed rank holding 0 bytes, the outputs equal
    to the reference's;
  * the mesh-needing cases of ``tests/test_reshard.py`` on 4 ranks: plan
    meshes and the shortfall, the swapper's compatibility gates and live
    callbacks, the pp=1 auto-detection;
  * the trainer's cross-rank checks raise on every rank when one rank's
    groups or loss differ;
  * the elastic trainer: its ``[fleet]`` line is the reference's
    (failures=1, joins=1, recoveries=2, degraded=0, committed=8,
    aborted=0), physical swaps >= 2, every rank's losses bitwise equal, the
    down rank trains nothing and holds nothing while down; the world-1
    trainer makes a physical swap, and traces one ``reshard`` span a swap.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SEED = 0
N_LAYERS, D, M, MB, S = 8, 16, 4, 2, 8
# (dp, pp, tp); the last needs 8 stages on 4 ranks: a clamped mesh
CHAIN = [(1, 4, 1), (2, 2, 1), (1, 2, 2), (1, 1, 4), (4, 1, 1), (1, 4, 1), (1, 8, 1)]
KINDS = ("tanh", "exact")
TRAINER = ["--tiny", "--device", "cpu", "--steps", "8", "--hosts", "4",
           "--fail-host-at", "3", "--revive-host-at", "6"]


def _inputs():
    """Weights and microbatches of both layer kinds, from one numpy seed."""
    rng = np.random.default_rng(SEED)
    perm = np.zeros((N_LAYERS, D, D), np.float32)
    for i in range(N_LAYERS):
        perm[i, np.arange(D), rng.permutation(D)] = rng.choice([-1.0, 1.0], D)
    return {"W/tanh": (rng.standard_normal((N_LAYERS, D, D)) * D ** -0.5).astype(np.float32),
            "W/exact": perm,
            "xs/tanh": rng.standard_normal((M, MB, S, D)).astype(np.float32),
            "xs/exact": (rng.integers(-32, 33, (M, MB, S, D)) / 4).astype(np.float32),
            "opt": rng.standard_normal((N_LAYERS, D, D)).astype(np.float32),
            "arange": np.arange(8 * 4, dtype=np.float32).reshape(8, 4)}


def _report(rep):
    return [list(rep.old_plan), list(rep.new_plan), rep.bytes_moved, rep.bytes_total,
            rep.n_leaves, rep.restacked]


# --------------------------------------------------------------------------- #
# The reference (subprocess, 4 forced host devices)
# --------------------------------------------------------------------------- #
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.core.optimizer.space import ModuleParallelism, ParallelismPlan
    from repro.core.pipeline.executor import (build_stage_fn, pipeline_forward,
                                              stack_stage_params)
    from repro.launch.fleet import FaultInjector, FleetManager, fleet_plan_mesh
    from repro.launch.reshard import clamped_plan_mesh, plan_mesh, reshard_params

    assert jax.device_count() == WORLD
    inp = _inputs()
    layer = {"tanh": lambda w, h: jnp.tanh(h @ w),
             "exact": lambda w, h: jax.nn.relu(h @ w) - 0.5 * h}
    out, meta = {}, {"reports": []}

    def plan(dp, pp, tp):
        return ParallelismPlan(llm=ModuleParallelism(tp, pp, dp), n_mb=M)

    def forward(params, mesh, pp, kind):
        stages = mesh.shape["stage"]
        if pp != stages:            # the executor takes one block a stage
            params = jax.device_put(stack_stage_params(params, stages, from_p=pp),
                                    NamedSharding(mesh, P("stage")))
        pipe = pipeline_forward(mesh, build_stage_fn(layer[kind], N_LAYERS // stages))
        with mesh:
            return np.asarray(pipe(params, jnp.asarray(inp[f"xs/{kind}"])))

    # the chain
    for kind in KINDS:
        p0 = plan(*CHAIN[0])
        params = jax.device_put(stack_stage_params(jnp.asarray(inp[f"W/{kind}"]), 4),
                                NamedSharding(plan_mesh(p0), P("stage")))
        out[f"chain/{kind}/0"] = forward(params, plan_mesh(p0), 4, kind)
        prev = p0
        for i, t in enumerate(CHAIN[1:], 1):
            nxt = plan(*t)
            fac = plan_mesh if nxt.llm.chips <= WORLD else clamped_plan_mesh
            params, rep = reshard_params(params, prev, nxt, stage_stacked=True,
                                         mesh_factory=fac)
            if kind == "tanh":
                meta["reports"].append(_report(rep))
                meta[f"chain_spec/{i}"] = list(params.sharding.spec)
            out[f"chain/{kind}/{i}"] = forward(params, fac(nxt), t[1], kind)
            prev = nxt

    # PP 3 on a 2-wide clamped stage axis: replicated
    W = jnp.asarray(inp["arange"][:6])
    mesh = clamped_plan_mesh(plan(1, 3, 1), devices=jax.devices()[:2])
    got, rep = reshard_params(stack_stage_params(W, 1), plan(1, 1, 1), plan(1, 3, 1),
                              stage_stacked=True, new_mesh=mesh)
    meta["clamp3"] = [dict(mesh.shape), list(got.sharding.spec), _report(rep)]

    # the fleet's divisor clamp and the stage sharding it keeps
    p4 = plan(1, 4, 1)
    three = jax.devices()[:3]
    fm = FleetManager(devices=jax.devices(), devices_per_host=1)
    fm.fail(3)
    meta["divisor"] = [dict(fleet_plan_mesh(p4, jax.devices()).shape),
                       dict(clamped_plan_mesh(p4, devices=three).shape),
                       dict(fleet_plan_mesh(p4, three).shape), dict(fm.plan_mesh(p4).shape)]
    W8 = jnp.asarray(inp["arange"])
    got_c, rc = reshard_params(stack_stage_params(W8, 4), p4, p4, stage_stacked=True,
                               new_mesh=clamped_plan_mesh(p4, devices=fm.devices()))
    got_f, rf = reshard_params(stack_stage_params(W8, 4), p4, p4, stage_stacked=True,
                               mesh_factory=fm.plan_mesh)
    new, ra = reshard_params(stack_stage_params(W8, 1), plan(1, 1, 1), p4,
                             mesh_factory=fm.plan_mesh)
    meta["keep"] = [list(got_c.sharding.spec), _report(rc), list(got_f.sharding.spec),
                    _report(rf), list(new.sharding.spec), list(new.shape), _report(ra)]

    # the fleet's N -> N-1 -> N with device 0 failing, a PP 2 plan
    p2 = plan(1, 2, 1)
    fm = FleetManager(devices=jax.devices(), devices_per_host=1)
    inj = FaultInjector(fm, {1: [("fail", 0)], 2: [("join", 0)]})
    for kind in KINDS:
        mesh0 = fm.plan_mesh(p2)
        params = jax.device_put(stack_stage_params(jnp.asarray(inp[f"W/{kind}"]), 2),
                                NamedSharding(mesh0, P("stage")))
        out[f"fleet/{kind}"] = forward(params, mesh0, 2, kind)
    meta["fleet_mesh"] = [d.id for d in fm.plan_mesh(p2).devices.flat]
    inj.on_step(1)
    meta["fleet_mesh_down"] = [d.id for d in fm.plan_mesh(p2).devices.flat]

    # the swapper's cases on 4 devices
    meta["meshes"] = [dict(plan_mesh(plan(2, 2, 1)).shape),
                      dict(clamped_plan_mesh(plan(2, 4, 8)).shape)]
    np.savez(out_path, meta=np.array(json.dumps(meta)), **out)


# --------------------------------------------------------------------------- #
# The port (one process a rank, gloo)
# --------------------------------------------------------------------------- #
def _rank(rank, store_path, out_path):
    import functools

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch import train_mllm
    from repro_torch.core.optimizer.space import ModuleParallelism, ParallelismPlan
    from repro_torch.core.pipeline.executor import (build_stage_fn, pipeline_forward,
                                                    stack_stage_params)
    from repro_torch.launch.fleet import FaultInjector, FleetManager, fleet_plan_mesh
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.launch.reshard import ParamSwapper, clamped_plan_mesh, plan_mesh
    from repro_torch.launch.reshard import reshard_params

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    pm = functools.partial(plan_mesh, device_type="cpu")
    cm = functools.partial(clamped_plan_mesh, device_type="cpu")
    inp = {k: torch.tensor(v) for k, v in _inputs().items()}
    layer = {"tanh": lambda w, h: torch.tanh(h @ w),
             "exact": lambda w, h: torch.relu(h @ w) - 0.5 * h}
    out, meta = {}, {"reports": [], "held": []}

    def plan(dp, pp, tp):
        return ParallelismPlan(llm=ModuleParallelism(tp, pp, dp), n_mb=M)

    def forward(placed, kind):
        """The pipeline over the placed state on its own mesh (ranks of it)."""
        if not placed.layout.holds(rank):
            return None
        stages = mesh_shape(placed.mesh)["stage"]
        pipe = pipeline_forward(placed.mesh, build_stage_fn(layer[kind], N_LAYERS // stages))
        with torch.no_grad():
            return pipe(placed, inp[f"xs/{kind}"]).numpy()

    def local(placed):
        """(block index, this rank's leaf) where it holds one."""
        lay = placed.layout
        return (lay.block_of(rank), placed.tree.numpy()) if lay.holds(rank) else None

    try:
        # the chain
        for kind in KINDS:
            p0 = plan(*CHAIN[0])
            state, _ = reshard_params(stack_stage_params(inp[f"W/{kind}"], 4), p0, p0,
                                      stage_stacked=True, mesh_factory=pm)
            o = forward(state, kind)
            if o is not None:
                out[f"chain/{kind}/0"] = o
            prev = p0
            for i, t in enumerate(CHAIN[1:], 1):
                nxt = plan(*t)
                fac = pm if nxt.llm.chips <= WORLD else cm
                state, rep = reshard_params(state, prev, nxt, stage_stacked=True,
                                            mesh_factory=fac)
                o = forward(state, kind)
                if o is not None:
                    out[f"chain/{kind}/{i}"] = o
                if kind == "tanh":
                    meta["reports"].append(_report(rep))
                    meta[f"chain_spec/{i}"] = list(state.spec)
                    meta["held"].append([state.local_bytes(), state.layout.ranks,
                                         state.layout.n_blocks])
                    blk = local(state)
                    if blk is not None:
                        out[f"chain_block/{i}"] = blk[1]
                        meta[f"chain_block/{i}"] = blk[0]
                prev = nxt

        # PP 3 on a 2-wide clamped stage axis: replicated on ranks 0 and 1
        mesh = clamped_plan_mesh(plan(1, 3, 1), ranks=[0, 1], device_type="cpu")
        got, rep = reshard_params(stack_stage_params(inp["arange"][:6], 1), plan(1, 1, 1),
                                  plan(1, 3, 1), stage_stacked=True, new_mesh=mesh)
        meta["clamp3"] = [mesh_shape(mesh), list(got.spec), _report(rep),
                          got.local_bytes(), got.shapes[0]]
        if got.layout.holds(rank):
            out["clamp3"] = got.tree.numpy()

        # the fleet's divisor clamp and the stage sharding it keeps
        p4 = plan(1, 4, 1)
        fm = FleetManager(device_type="cpu")
        ex = mesh_shape(fleet_plan_mesh(p4, range(WORLD), "cpu"))
        fm.fail(3)
        meta["divisor"] = [ex, mesh_shape(cm(p4, ranks=[0, 1, 2])),
                           mesh_shape(fleet_plan_mesh(p4, [0, 1, 2], "cpu")),
                           mesh_shape(fm.plan_mesh(p4))]
        try:
            fleet_plan_mesh(p4, [], "cpu")
        except ValueError as e:
            meta["empty"] = str(e)
        W8 = inp["arange"]
        got_c, rc = reshard_params(stack_stage_params(W8, 4), p4, p4, stage_stacked=True,
                                   new_mesh=cm(p4, ranks=fm.devices()))
        got_f, rf = reshard_params(stack_stage_params(W8, 4), p4, p4, stage_stacked=True,
                                   mesh_factory=fm.plan_mesh)
        new, ra = reshard_params(stack_stage_params(W8, 1), plan(1, 1, 1), p4,
                                 mesh_factory=fm.plan_mesh)
        meta["keep"] = [list(got_c.spec), _report(rc), list(got_f.spec), _report(rf),
                        list(new.spec), list(new.shapes[0]), _report(ra)]
        for tag, placed in (("keep_f", got_f), ("keep_a", new)):
            blk = local(placed)
            if blk is not None:
                meta[tag] = blk[0]
                out[tag] = blk[1]

        # the fleet's N -> N-1 -> N with rank 0 failing, a PP 2 plan
        p2 = plan(1, 2, 1)
        fm = FleetManager(device_type="cpu")
        inj = FaultInjector(fm, {1: [("fail", 0)], 2: [("join", 0)]})
        live = {}
        for kind in KINDS:
            live[kind], _ = reshard_params(
                (stack_stage_params(inp[f"W/{kind}"], 2), stack_stage_params(inp["opt"], 2)),
                p2, p2, stage_stacked=True, mesh_factory=fm.plan_mesh)
        swappers = {kind: ParamSwapper(lambda k=kind: live[k],
                                       lambda s, k=kind: live.__setitem__(k, s),
                                       stage_stacked=True, mesh_factory=fm.plan_mesh)
                    for kind in KINDS}
        for phase, step in (("up", None), ("down", 1), ("rejoin", 2)):
            if step is not None:
                inj.on_step(step)
                for kind in KINDS:
                    swappers[kind].refresh(p2)
            meta[f"fleet/{phase}"] = [live["tanh"].layout.ranks, live["tanh"].local_bytes(),
                                      fm.alive_ids()]
            for kind in KINDS:
                o = forward(live[kind][0], kind)
                if o is not None:
                    out[f"fleet/{phase}/{kind}"] = o
                blk = local(live[kind][1])
                if blk is not None:
                    meta[f"fleet/{phase}/opt_block"] = blk[0]
                    out[f"fleet/{phase}/opt/{kind}"] = blk[1]
        meta["fleet/fired"] = [e.kind for e in inj.fired]
        meta["fleet/reports"] = [len(swappers[k].reports) for k in KINDS]

        # the swapper's cases that need several ranks
        meta["meshes"] = [mesh_shape(pm(plan(2, 2, 1))), mesh_shape(cm(plan(2, 4, 8)))]
        try:
            pm(plan(2, 4, 1))
        except ValueError as e:
            meta["shortfall"] = str(e)
        box = {"p": stack_stage_params(inp["arange"], 4)}
        sw = ParamSwapper(lambda: box["p"], lambda v: box.update(p=v), stage_stacked=True,
                          mesh_factory=cm)
        meta["compatible"] = [sw.compatible(plan(1, 4, 1), plan(1, 2, 1)),
                              sw.compatible(plan(1, 4, 1), plan(1, 3, 1)),
                              ParamSwapper(lambda: box["p"], lambda v: None,
                                           mesh_factory=pm).compatible(plan(1, 1, 1),
                                                                       plan(4, 1, 8))]
        rep = sw.swap(plan(1, 4, 1), plan(1, 2, 1))
        meta["callback"] = [_report(rep), box["p"].shapes[0], list(box["p"].spec),
                            box["p"].layout.ranks]
        blk = local(box["p"])
        if blk is not None:
            meta["callback_block"] = blk[0]
            out["callback"] = blk[1]

        # the trainer's cross-rank checks: one rank's groups, then its loss
        class Out:
            plan = p2
            groups = [[0, 1], [2, 3 if rank != 3 else 4]]

        for name, fn in (("agree", lambda: train_mllm._agree(0, Out, None, None)),
                         ("loss", lambda: train_mllm._agreed_loss(
                             0, None if rank == 0 else 1.0 + (rank == 2) * 2 ** -20))):
            try:
                fn()
                meta[f"check/{name}"] = "passed"
            except RuntimeError as e:
                meta[f"check/{name}"] = str(e)
        meta["check/same"] = train_mllm._agreed_loss(1, None if rank == 3 else 0.5)
    finally:
        dist.destroy_process_group()
    np.savez(out_path, meta=np.array(json.dumps(meta)), **out)


# --------------------------------------------------------------------------- #
# one pool for the file
# --------------------------------------------------------------------------- #
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs, timeout):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch

    from repro_torch import train_mllm

    tmp = tmp_path_factory.mktemp("elastic")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               OMP_NUM_THREADS="1")
    me = os.path.abspath(__file__)
    t0 = time.perf_counter()
    ref = subprocess.Popen([sys.executable, me, "reference", str(tmp / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ranks = [subprocess.Popen([sys.executable, me, "rank", str(k), str(tmp / "store"),
                               str(tmp / f"rank{k}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(WORLD)]
    port = str(_free_port())
    trainers = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.train_mllm", *TRAINER], cwd=ROOT,
        env=dict(env, RANK=str(k), LOCAL_RANK=str(k), WORLD_SIZE=str(WORLD),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(WORLD)]
    procs = [ref, *ranks, *trainers]
    try:
        # meanwhile, the trainer alone: a world of 1 of its own
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        trace = str(tmp / "trace.json")
        try:
            solo = train_mllm.run(train_mllm.parse_args(
                ["--tiny", "--device", "cpu", "--steps", "24", "--shift-at", "6",
                 "--replan", "--trace", trace]))
        finally:
            torch.set_num_threads(threads)
        t1 = time.perf_counter()
        logs = _wait(procs, 600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    print(f"trainer alone {t1 - t0:.1f} s, everything {time.perf_counter() - t0:.1f} s")
    load = lambda path: (lambda z: (json.loads(str(z["meta"])),          # noqa: E731
                                    {k: z[k] for k in z.files if k != "meta"}))(np.load(path))
    return dict(ref=load(tmp / "ref.npz"), ranks=[load(tmp / f"rank{k}.npz")
                                                  for k in range(WORLD)],
                trainer=logs[1 + WORLD:], solo=solo, trace=json.load(open(trace)))


# --------------------------------------------------------------------------- #
# reshard
# --------------------------------------------------------------------------- #
def test_reshard_chain_keeps_pipeline_outputs_bitwise(runs):
    _, rout = runs["ref"]
    for kind in KINDS:
        first = next(out[f"chain/{kind}/0"] for _, out in runs["ranks"])
        for i, t in enumerate(CHAIN):
            got = [out[f"chain/{kind}/{i}"] for _, out in runs["ranks"]
                   if f"chain/{kind}/{i}" in out]
            # every rank of the mesh ran it: all 4 (an 8-stage plan on 4 ranks too)
            assert len(got) == WORLD, (kind, t)
            for g in got:
                np.testing.assert_array_equal(g, first, err_msg=f"{kind} {t}")
            want = rout[f"chain/{kind}/{i}"]
            if kind == "exact":
                np.testing.assert_array_equal(got[0], want, err_msg=str(t))
            else:
                np.testing.assert_allclose(got[0], want, rtol=1e-6, atol=1e-6)
        if kind == "exact":
            # the sequential composition in float64 gives the same values
            h = _inputs()["xs/exact"].astype(np.float64)
            for w in _inputs()["W/exact"]:
                h = np.maximum(h @ w, 0) - 0.5 * h
            np.testing.assert_array_equal(first, h)


def test_reshard_chain_reports_equal_reference(runs):
    rmeta, _ = runs["ref"]
    total = N_LAYERS * D * D * 4
    for meta, _ in runs["ranks"]:
        assert meta["reports"] == rmeta["reports"]
        for i, (rep, t) in enumerate(zip(meta["reports"], CHAIN[1:]), 1):
            assert rep[2] == rep[3] == total, rep         # every byte moves
            assert rep[5] == (CHAIN[i - 1][1] != t[1])    # restacked iff PP changed
            assert meta[f"chain_spec/{i}"] == rmeta[f"chain_spec/{i}"] == ["stage"]


def test_reshard_chain_each_rank_holds_its_block(runs):
    W = _inputs()["W/tanh"]
    for i, t in enumerate(CHAIN[1:], 1):
        pp = t[1]
        stacked = W.reshape(pp, N_LAYERS // pp, D, D)
        for meta, out in runs["ranks"]:
            held, ranks, blocks = meta["held"][i - 1]
            assert ranks == list(range(WORLD)) and blocks == min(pp, WORLD // t[2] // t[0])
            b, k = meta[f"chain_block/{i}"], pp // blocks
            np.testing.assert_array_equal(out[f"chain_block/{i}"], stacked[b * k:(b + 1) * k])
            assert held == W.nbytes // blocks


def test_reshard_clamped_mesh_replicates_non_divisible_stage(runs):
    rmeta, _ = runs["ref"]
    W = _inputs()["arange"][:6]
    for k, (meta, out) in enumerate(runs["ranks"]):
        shape, spec, rep, held, gshape = meta["clamp3"]
        assert [shape, spec, rep] == rmeta["clamp3"]
        assert shape["stage"] == 2 and spec == [] and rep[5] and gshape == [3, 2, 4]
        if k < 2:
            np.testing.assert_array_equal(out["clamp3"].reshape(6, 4), W)
            assert held == W.nbytes
        else:
            assert "clamp3" not in out and held == 0


# --------------------------------------------------------------------------- #
# fleet
# --------------------------------------------------------------------------- #
def test_fleet_plan_mesh_divisor_clamp(runs):
    rmeta, _ = runs["ref"]
    for meta, _ in runs["ranks"]:
        assert meta["divisor"] == rmeta["divisor"]
        assert meta["divisor"][0] == {"data": 1, "stage": 4, "model": 1}
        assert [m["stage"] for m in meta["divisor"][1:]] == [3, 2, 2]
        assert "empty roster" in meta["empty"]


def test_fleet_reshard_keeps_stage_sharding_on_shrunken_roster(runs):
    rmeta, _ = runs["ref"]
    W = _inputs()["arange"]
    for k, (meta, out) in enumerate(runs["ranks"]):
        assert meta["keep"] == rmeta["keep"]
        assert meta["keep"][0] == [] and meta["keep"][2] == ["stage"]
        assert meta["keep"][4] == ["stage"] and meta["keep"][5] == [4, 2, 4]
        for tag in ("keep_f", "keep_a"):
            if k < 2:                                     # a 2-wide stage axis
                b = meta[tag]
                np.testing.assert_array_equal(out[tag].reshape(-1, 4), W[4 * b:4 * b + 4])
            else:
                assert tag not in out


def test_fleet_pipeline_bit_identical_across_roster_transitions(runs):
    rmeta, rout = runs["ref"]
    opt = _inputs()["opt"].reshape(2, 4, D, D)
    metas = [m for m, _ in runs["ranks"]]
    assert metas[0]["fleet/up"][0] == [0, 1] and metas[0]["fleet/down"][0] == [1, 2]
    assert metas[0]["fleet/rejoin"][0] == [0, 1]
    assert rmeta["fleet_mesh"] == [0, 1] and rmeta["fleet_mesh_down"] == [1, 2]
    for phase, holders in (("up", (0, 1)), ("down", (1, 2)), ("rejoin", (0, 1))):
        for k, (meta, out) in enumerate(runs["ranks"]):
            ranks, held, alive = meta[f"fleet/{phase}"]
            assert alive == ([1, 2, 3] if phase == "down" else [0, 1, 2, 3])
            if k not in holders:
                # the failed rank (and the unused one) hold 0 bytes of the state
                assert held == 0 and f"fleet/{phase}/tanh" not in out
                continue
            assert held == 2 * N_LAYERS * D * D * 4 // 2
            for kind in KINDS:
                got = out[f"fleet/{phase}/{kind}"]
                np.testing.assert_array_equal(got, runs["ranks"][1][1][f"fleet/up/{kind}"])
                if kind == "exact":
                    np.testing.assert_array_equal(got, rout["fleet/exact"])
                else:
                    np.testing.assert_allclose(got, rout["fleet/tanh"], rtol=1e-6, atol=1e-6)
                # the optimizer state survives exactly
                b = meta[f"fleet/{phase}/opt_block"]
                np.testing.assert_array_equal(out[f"fleet/{phase}/opt/{kind}"],
                                              opt[b:b + 1])
    for meta in metas:
        assert meta["fleet/fired"] == ["fail", "join"] and meta["fleet/reports"] == [2, 2]


def test_reshard_cases_on_four_ranks(runs):
    rmeta, _ = runs["ref"]
    W = _inputs()["arange"]
    for k, (meta, out) in enumerate(runs["ranks"]):
        assert meta["meshes"] == rmeta["meshes"]
        assert meta["meshes"][0] == {"data": 2, "stage": 2, "model": 1}
        assert "needs 8 ranks, have 4" in meta["shortfall"]
        assert meta["compatible"] == [True, False, False]
        rep, shape, spec, ranks = meta["callback"]
        assert rep[5] and rep[2] == rep[3] == W.nbytes
        assert shape == [2, 4, 4] and spec == ["stage"] and ranks == [0, 1]
        if k < 2:
            b = meta["callback_block"]
            np.testing.assert_array_equal(out["callback"].reshape(4, 4), W[4 * b:4 * b + 4])


def test_trainer_cross_rank_checks_raise_on_every_rank(runs):
    for meta, _ in runs["ranks"]:
        assert "ranks disagree at step 0" in meta["check/agree"]
        assert "losses differ" in meta["check/loss"]
        assert meta["check/same"] == 0.5


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
def _field(line, key):
    return line.split(f"{key}=")[1].split()[0]


def test_train_mllm_elastic_on_four_ranks(runs):
    logs = runs["trainer"]
    lead = logs[0]
    fleet_line = [ln for ln in lead.splitlines() if ln.startswith("[fleet] hosts=")][0]
    assert "failures=1" in fleet_line and "joins=1" in fleet_line
    assert "recoveries=2" in fleet_line and "degraded=0" in fleet_line
    assert "committed=8" in fleet_line and "aborted=0" in fleet_line
    runtime = [ln for ln in lead.splitlines() if "physical_swaps=" in ln][0]
    assert int(_field(runtime, "physical_swaps")) >= 2, lead
    lines = []
    for k, log in enumerate(logs):
        ln = [x for x in log.splitlines() if x.startswith(f"[losses] rank {k} ")]
        assert len(ln) == 1, log
        lines.append(ln[0])
    losses = [ln.split(" losses ")[1] for ln in lines]
    assert len(set(losses)) == 1, lines           # bit for bit: repr round-trips
    vals = json.loads(losses[0])
    assert len(vals) == 8 and all(np.isfinite(vals))
    # the last host is down over steps 3-5: it trains none of them
    trained = json.loads(lines[3].split(" trained ")[1].split(" holds ")[0])
    assert not {3, 4, 5} & set(trained) and {0, 1, 2} <= set(trained)
    assert json.loads(lines[0].split(" trained ")[1].split(" holds ")[0]) == list(range(8))


def test_train_mllm_alone_makes_a_physical_swap(runs):
    solo = runs["solo"]
    snap = solo["ctl"].metrics.snapshot()
    assert snap["n_physical_swaps"] >= 1 and snap["n_replans"] >= 1
    evs = [e for e in runs["trace"]["traceEvents"] if e["name"] == "reshard"]
    assert len(evs) == snap["n_physical_swaps"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
    assert "plan-swap" in {e["name"] for e in runs["trace"]["traceEvents"]}
    rep = solo["swapper"].reports[0]
    assert rep.bytes_moved == rep.bytes_total > 0 and not rep.restacked
    assert solo["state"].layout.ranks == (0,) and solo["trained"] == list(range(24))
    assert all(np.isfinite(s["loss"]) for s in solo["steps"])


def test_train_mllm_hosts_argument_errors():
    import torch.distributed as dist

    from repro_torch import train_mllm

    for argv in (["--fail-host-at", "3"], ["--revive-host-at", "3"],
                 ["--hosts", "4", "--random"], ["--hosts", "4", "--compose-window", "2"]):
        with pytest.raises(SystemExit):
            train_mllm.parse_args(argv)
    assert not dist.is_initialized() and "WORLD_SIZE" not in os.environ
    with pytest.raises(RuntimeError, match="--hosts runs one process a rank"):
        train_mllm.run(train_mllm.parse_args(["--tiny", "--device", "cpu", "--steps", "1",
                                              "--hosts", "4"]))
    assert not dist.is_initialized()


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), *sys.argv[3:5])
