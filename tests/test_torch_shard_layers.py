"""The sharded layer paths on 4 gloo ranks against the reference's
``shard_map`` paths at 4 forced host devices.

The reference runs once for the file in a subprocess (its device count is
fixed at jax's first init), writing its inputs and results to an ``.npz``;
then 4 rank processes run the port under gloo on a ``FileStore`` and write
one ``.npz`` each.  No process group starts inside the pytest worker.  Run
alone (~1 min): ``PYTHONPATH=src python -m pytest -q tests/test_torch_shard_layers.py``.

Cases (inputs from one numpy seed, the reference's weights as numpy), each
against the reference's ``jax.grad`` through the same path on the same mesh
shape, a ("data", "model") mesh:
  * MoE ``apply_ep_shard_map``, E 8 on (1, 4) and on (2, 2) (expert
    parallelism: 2 and 4 experts a rank), and E 6 on (1, 4) (the TP-expert
    path, d_ff 64 over 4), capacity factor 1.25 (pairs drop), loss
    sum(y * cot) + lb: y, lb, the gradients of x, of the router and of each
    rank's expert slices (the router's and the slices' summed over the data
    axis: a rank's gradient is over its own rows);
  * the ``None`` cases (model size 1; E 6 with d_ff 130 on 4), where
    ``moe.apply(impl="ep")`` equals the capacity path;
  * ``ssm_scan_sharded`` (B 4, S 32, di 16, N 8) on (1, 4) and (2, 2), and
    its chunked inner scan on (1, 4): y, h (the rank's channels) and the
    gradients of all six inputs;
  * a tiny hybrid (Mamba and attention layers, MoE on every other layer, E
    4: expert parallel; E 6: TP experts) through ``make_loss_fn`` with
    ``FwdCtx(shard_ctx, moe_impl="ep", ssm_impl="chunked")`` on (1, 4);
  * ``sharding.expert_shards`` against the reference's addressable shards
    of the same leaves under ``param_specs`` (in the pytest process, on a
    stand-in mesh).

Tolerances (fp32; the two packages sum in other orders): y, h, lb and loss
rtol 1e-5 (arrays also atol 1e-5 of their largest element); gradients rtol
1e-4, atol 1e-6 of each leaf's largest element.  The hybrid's model
gradients against the reference: atol 1e-5 of the leaf's largest element
(the unsharded port is that far from the reference already), and against
the port's own unsharded step the layer tolerance.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SEED = 0
MB, MS, MD = 4, 8, 32                # MoE layer: x (B, S, d)
CF, LBW = 1.25, 1.0                  # capacity factor; lb's weight in the loss
# tag: (experts, d_ff, mesh shape, the path taken on 4 ranks)
MOE_CASES = {"ep8_1x4": (8, 64, (1, 4), "ep"), "ep8_2x2": (8, 64, (2, 2), "ep"),
             "tp6_1x4": (6, 64, (1, 4), "tp"), "none_4x1": (8, 64, (4, 1), None),
             "none_ff130": (6, 130, (1, 4), None)}
SB, SS, SDI, SN = 4, 32, 16, 8       # the selective scan
SCAN_CASES = {"xla_1x4": ((1, 4), False), "xla_2x2": ((2, 2), False),
              "chunked_1x4": ((1, 4), True)}
HYB_E = (4, 6)                       # the tiny hybrid's experts on (1, 4)
HB, HS, VOCAB = 2, 16, 64
MESHES = ((1, 4), (2, 2), (4, 1))


def _moe_cfg(t, E, ff):
    return t.ModelConfig(name="moe-tiny", family="moe", n_layers=2, d_model=MD,
                         n_heads=4, n_kv_heads=4, d_ff=ff, vocab_size=97,
                         ffn_pattern=("moe",), n_experts=E, top_k=2, dtype="float32")


def _hybrid_cfg(t, E):
    return t.ModelConfig(name=f"hybrid-moe{E}", family="hybrid", n_layers=4,
                         d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                         vocab_size=VOCAB, layer_pattern=("mamba", "attention"),
                         ffn_pattern=("dense", "moe"), n_experts=E, top_k=2,
                         dtype="float32")


def _assign(t):
    return t.ModuleAssignment(llm=t.AxisAssignment(batch=("data",), tensor=("model",)))


def _flat(tree, prefix):
    """'/'-joined paths of a nested dict of arrays -> {prefix/path: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _nest(flat, prefix):
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _rows(shape, d):
    """A data rank's rows of a batch of MB (= SB) rows."""
    n = MB // shape[0]
    return slice(d * n, (d + 1) * n)


# --------------------------------------------------------------------------- #
# The reference (subprocess, 4 forced host devices)
# --------------------------------------------------------------------------- #
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from repro.common import types as jtypes
    from repro.launch.mesh import compat_make_mesh
    from repro.models import model as jmodel
    from repro.models.layers import mamba as jmamba
    from repro.models.layers import moe as jmoe
    from repro.sharding import partition as jpart
    from repro.train import step as jstep

    assert jax.device_count() == WORLD
    rng = np.random.default_rng(SEED)
    r = {}
    meshes = {s: compat_make_mesh(s, ("data", "model")) for s in MESHES}

    # MoE layers
    r["moe/x"] = rng.standard_normal((MB, MS, MD)).astype(np.float32)
    r["moe/cot"] = rng.standard_normal((MB, MS, MD)).astype(np.float32)
    x, cot = jnp.asarray(r["moe/x"]), jnp.asarray(r["moe/cot"])
    for tag, (E, ff, shape, _) in MOE_CASES.items():
        cfg = _moe_cfg(jtypes, E, ff)
        p = jmoe.init(jax.random.PRNGKey(SEED + E + ff), cfg)
        r.update(_flat(jax.tree.map(np.asarray, p), f"moe/{tag}/params"))
        mesh = meshes[shape]
        ctx = (mesh, ("data",), ("model",))
        f = lambda p, x: jmoe.apply_ep_shard_map(p, x, cfg, ctx,    # noqa: E731
                                                 capacity_factor=CF)
        with mesh:
            if f(p, x) is None:
                r[f"moe/{tag}/none"] = np.array(True)
                continue

            def loss(p, x):
                y, lb = f(p, x)
                return jnp.sum(y * cot) + LBW * lb, (y, lb)

            (l, (y, lb)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(p, x)
        r[f"moe/{tag}/none"] = np.array(False)
        r[f"moe/{tag}/loss"], r[f"moe/{tag}/y"], r[f"moe/{tag}/lb"] = map(
            np.asarray, (l, y, lb))
        r[f"moe/{tag}/gx"] = np.asarray(gx)
        r.update(_flat(jax.tree.map(np.asarray, gp), f"moe/{tag}/grads"))

    # the sharded selective scan
    r["scan/u"] = rng.standard_normal((SB, SS, SDI)).astype(np.float32)
    r["scan/dt"] = np.log1p(np.exp(rng.standard_normal((SB, SS, SDI)))).astype(np.float32)
    r["scan/B"] = rng.standard_normal((SB, SS, SN)).astype(np.float32)
    r["scan/C"] = rng.standard_normal((SB, SS, SN)).astype(np.float32)
    r["scan/A"] = -np.exp(0.3 * rng.standard_normal((SDI, SN))).astype(np.float32)
    r["scan/D"] = rng.standard_normal((SDI,)).astype(np.float32)
    r["scan/cot_y"] = rng.standard_normal((SB, SS, SDI)).astype(np.float32)
    r["scan/cot_h"] = rng.standard_normal((SB, SDI, SN)).astype(np.float32)
    args = [jnp.asarray(r[f"scan/{k}"]) for k in ("u", "dt", "B", "C", "A", "D")]
    for tag, (shape, chunked) in SCAN_CASES.items():
        mesh = meshes[shape]
        ctx = (mesh, ("data",), ("model",))

        def loss(*a):
            y, h = jmamba.ssm_scan_sharded(*a, ctx, chunked=chunked)
            return (jnp.sum(y * r["scan/cot_y"]) + jnp.sum(h * r["scan/cot_h"]), (y, h))

        with mesh:
            (_, (y, h)), g = jax.jit(jax.value_and_grad(
                loss, argnums=tuple(range(6)), has_aux=True))(*args)
        r[f"scan/{tag}/y"], r[f"scan/{tag}/h"] = np.asarray(y), np.asarray(h)
        for k, gk in zip(("u", "dt", "B", "C", "A", "D"), g):
            r[f"scan/{tag}/g{k}"] = np.asarray(gk)

    # the tiny hybrid through make_loss_fn under shard_ctx, and the
    # addressable shards of its expert leaves under param_specs
    r["hyb/tokens"] = rng.integers(0, VOCAB, (HB, HS)).astype(np.int32)
    r["hyb/labels"] = rng.integers(-1, VOCAB, (HB, HS)).astype(np.int32)
    batch = {"tokens": jnp.asarray(r["hyb/tokens"]), "labels": jnp.asarray(r["hyb/labels"])}
    mesh = meshes[(1, 4)]
    for E in HYB_E:
        cfg = _hybrid_cfg(jtypes, E)
        p = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(SEED + E), cfg)
        r.update(_flat(jax.tree.map(np.asarray, p), f"hyb/{E}/params"))
        ctx = jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="chunked",
                            moe_impl="ep", shard_ctx=(mesh, ("data",), ("model",)))
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg, ctx)))(p, batch)
        r[f"hyb/{E}/loss"] = np.asarray(loss)
        r.update(_flat(jax.tree.map(np.asarray, grads), f"hyb/{E}/grads"))
        for shape in ((1, 4), (2, 2)):
            cmesh = meshes[shape]
            specs = jpart.param_specs(p, _assign(jpart), cmesh)
            flat_p, flat_s = _flat(p, "p"), dict(jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0])
            for path, spec in flat_s.items():
                key = "p/" + "/".join(str(k.key) for k in path)
                if "/moe/w_" not in key:
                    continue
                arr = jax.device_put(flat_p[key], NamedSharding(cmesh, spec))
                for sh in arr.addressable_shards:
                    d, m = (int(i[0]) for i in np.nonzero(cmesh.devices == sh.device))
                    r[f"cut/{E}/{shape[0]}x{shape[1]}/{d}_{m}/{key[2:]}"] = np.asarray(sh.data)
    np.savez(out_path, **r)


# --------------------------------------------------------------------------- #
# The port (one process a rank, gloo)
# --------------------------------------------------------------------------- #
def _rank(rank, store_path, ref_path, out_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.common import types
    from repro_torch.common.pytree import tree_map, tree_paths
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import mamba, moe
    from repro_torch.models.model import FwdCtx
    from repro_torch.sharding import partition
    from repro_torch.train import step

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    ref = dict(np.load(ref_path))
    t = lambda a: torch.tensor(np.asarray(a))                        # noqa: E731
    leaf = lambda a: t(a).requires_grad_(True)                        # noqa: E731
    out = {}
    try:
        meshes = {s: make_mesh(s, ("data", "model"), device_type="cpu") for s in MESHES}
        assign = _assign(partition)

        # MoE layers: this rank's rows, the router whole, its expert slices
        for tag, (E, ff, shape, path) in MOE_CASES.items():
            cfg = _moe_cfg(types, E, ff)
            mesh = meshes[shape]
            ctx = (mesh, ("data",), ("model",))
            d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
            rows = _rows(shape, d)
            full = {k: t(v) for k, v in _nest(ref, f"moe/{tag}/params").items()}
            p = partition.expert_shards({"l": {"moe": full}}, assign, mesh)["l"]["moe"]
            p = {k: v.requires_grad_(True) for k, v in p.items()}
            x = leaf(ref["moe/x"][rows])
            res = moe.apply_ep_shard_map(p, x, cfg, ctx, capacity_factor=CF)
            if path is None:
                # None, and impl="ep" falls through to the capacity path
                y_ep, lb_ep, st = moe.apply(full, x, cfg, impl="ep", capacity_factor=CF,
                                            shard_ctx=ctx, with_stats=True)
                y_cap, lb_cap = moe.apply_capacity(full, x, cfg, capacity_factor=CF)
                out[f"moe/{tag}/none"] = np.array(
                    [res is None, torch.equal(y_ep, y_cap), torch.equal(lb_ep, lb_cap),
                     bool(torch.isfinite(st["drop_rate"]))])
                continue
            y, lb = res
            loss = (y * t(ref["moe/cot"][rows])).sum() + LBW * lb
            loss.backward()
            out[f"moe/{tag}/y"], out[f"moe/{tag}/lb"] = y.detach().numpy(), lb.detach().numpy()
            out[f"moe/{tag}/loss"] = loss.detach().numpy()
            out[f"moe/{tag}/gx"] = x.grad.numpy()
            for k, v in p.items():
                out[f"moe/{tag}/grads/{k}"] = v.grad.numpy()
            # the path-level stats are NaN through apply
            _, _, st = moe.apply(p, x.detach(), cfg, impl="ep", capacity_factor=CF,
                                 shard_ctx=ctx, with_stats=True)
            out[f"moe/{tag}/stats_nan"] = np.array(
                [bool(torch.isnan(st["drop_rate"])), bool(torch.isnan(st["imbalance"]))])
            out[f"moe/{tag}/coords"] = np.array([d, m])

        # the sharded selective scan: this rank's rows, every channel
        for tag, (shape, chunked) in SCAN_CASES.items():
            mesh = meshes[shape]
            d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")
            rows = _rows(shape, d)
            ins = [leaf(ref[f"scan/{k}"][rows]) for k in ("u", "dt", "B", "C")] + \
                [leaf(ref["scan/A"]), leaf(ref["scan/D"])]
            y, h = mamba.ssm_scan_sharded(*ins, (mesh, ("data",), ("model",)),
                                          chunked=chunked)
            chans = slice(m * SDI // shape[1], (m + 1) * SDI // shape[1])
            loss = (y * t(ref["scan/cot_y"][rows])).sum() + \
                (h * t(ref["scan/cot_h"][rows, chans])).sum()
            loss.backward()
            out[f"scan/{tag}/y"], out[f"scan/{tag}/h"] = y.detach().numpy(), h.detach().numpy()
            for k, a in zip(("u", "dt", "B", "C", "A", "D"), ins):
                out[f"scan/{tag}/g{k}"] = a.grad.numpy()
            out[f"scan/{tag}/coords"] = np.array([d, m])

        # the tiny hybrid through make_loss_fn under shard_ctx
        mesh = meshes[(1, 4)]
        batch = {"tokens": t(ref["hyb/tokens"]), "labels": t(ref["hyb/labels"])}
        for E in HYB_E:
            cfg = _hybrid_cfg(types, E)
            whole = params_from_jax(_nest(ref, f"hyb/{E}/params"), cfg, device="cpu")
            p = partition.expert_shards(whole, assign, mesh)
            ctx = FwdCtx(ssm_impl="chunked", moe_impl="ep",
                         shard_ctx=(mesh, ("data",), ("model",)))
            loss = step.make_loss_fn(cfg, ctx)(p, batch)
            loss.backward()
            out[f"hyb/{E}/loss"] = loss.detach().numpy()
            for path, a in tree_paths(p):
                out[f"hyb/{E}/grads/{path}"] = a.grad.numpy()
            # the same step unsharded, in this package (no collective): its
            # gradients, the expert leaves cut to this rank's slices
            whole = params_from_jax(_nest(ref, f"hyb/{E}/params"), cfg, device="cpu")
            loss = step.make_loss_fn(cfg, FwdCtx(ssm_impl="chunked"))(whole, batch)
            loss.backward()
            out[f"hyb/{E}/loss0"] = loss.detach().numpy()
            g0 = partition.expert_shards(tree_map(lambda a: a.grad, whole), assign, mesh)
            for path, g in tree_paths(g0):
                out[f"hyb/{E}/grads0/{path}"] = g.numpy()
        out["coords"] = np.array([mesh.get_local_rank("data"), mesh.get_local_rank("model")])
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_layers")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               OMP_NUM_THREADS="1")
    me = os.path.abspath(__file__)
    t0 = time.perf_counter()
    ref_path = str(tmp / "ref.npz")
    r = subprocess.run([sys.executable, me, "reference", ref_path], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    t1 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, me, "rank", str(k), str(tmp / "store"),
                               ref_path, str(tmp / f"rank{k}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    print(f"reference {t1 - t0:.1f} s, ranks {time.perf_counter() - t1:.1f} s")
    return (dict(np.load(ref_path)),
            [dict(np.load(tmp / f"rank{k}.npz")) for k in range(WORLD)])


def _close(got, want, rtol=1e-5):
    """Values (y, h, lb, loss): rtol 1e-5, atol 1e-5 of the largest element."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max(initial=0.0)))


def _grad_close(got, want):
    """A gradient leaf: rtol 1e-4, atol 1e-6 of the leaf's largest element."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max(initial=0.0)))


def _expert_slice(a, name, E, m, msize):
    """Rank m's slice of a whole expert leaf (param_specs' spec)."""
    if E % msize == 0:
        n = E // msize
        return a[m * n:(m + 1) * n]
    dim = 1 if name == "w_down" else 2
    n = a.shape[dim] // msize
    return np.take(a, range(m * n, (m + 1) * n), axis=dim)


@pytest.mark.parametrize("tag", [k for k, v in MOE_CASES.items() if v[3]])
def test_sharded_moe_matches_reference(runs, tag):
    ref, ranks = runs
    E, _, shape, _ = MOE_CASES[tag]
    by = {tuple(o[f"moe/{tag}/coords"]): o for o in ranks}
    assert sorted(by) == [(d, m) for d in range(shape[0]) for m in range(shape[1])]
    for (d, m), o in by.items():
        rows = _rows(shape, d)
        _close(o[f"moe/{tag}/y"], ref[f"moe/{tag}/y"][rows])
        _close(o[f"moe/{tag}/lb"], ref[f"moe/{tag}/lb"])
        _grad_close(o[f"moe/{tag}/gx"], ref[f"moe/{tag}/gx"][rows])
        assert o[f"moe/{tag}/stats_nan"].all()
    for m in range(shape[1]):
        # a rank's gradient is over its rows: summed over the data axis
        for name in ("router", "w_up", "w_gate", "w_down"):
            got = sum(by[(d, m)][f"moe/{tag}/grads/{name}"] for d in range(shape[0]))
            want = ref[f"moe/{tag}/grads/{name}"]
            if name != "router":
                want = _expert_slice(want, name, E, m, shape[1])
            _grad_close(got, want)
            ratio = np.linalg.norm(got) / np.linalg.norm(want)
            assert abs(ratio - 1) < 1e-4, (name, ratio)


def test_sharded_moe_none_falls_back_to_capacity(runs):
    ref, ranks = runs
    for tag, (_, _, _, path) in MOE_CASES.items():
        if path is not None:
            continue
        assert bool(ref[f"moe/{tag}/none"])
        for o in ranks:
            # None; apply(impl="ep") equal to the capacity path (y, lb), stats finite
            assert o[f"moe/{tag}/none"].tolist() == [True, True, True, True], tag


@pytest.mark.parametrize("E", [8, 6])
def test_sharded_moe_refuses_whole_expert_leaves(E):
    """A whole expert leaf on the EP (E 8) or TP (E 6) path of 4 model ranks
    raises before any collective (it would be summed over the ranks)."""
    import torch

    from repro_torch.common import types
    from repro_torch.models.layers import moe

    class StandIn:
        shape = {"data": 1, "model": 4}

        def get_local_rank(self, axis):
            return 0

    cfg = _moe_cfg(types, E, 64)
    p = moe.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="expert_shards"):
        moe.apply_ep_shard_map(p, torch.zeros(1, 4, MD), cfg,
                               (StandIn(), ("data",), ("model",)))


@pytest.mark.parametrize("tag", list(SCAN_CASES))
def test_sharded_mamba_scan_matches_reference(runs, tag):
    ref, ranks = runs
    shape, _ = SCAN_CASES[tag]
    by = {tuple(o[f"scan/{tag}/coords"]): o for o in ranks}
    for (d, m), o in by.items():
        rows = _rows(shape, d)
        chans = slice(m * SDI // shape[1], (m + 1) * SDI // shape[1])
        _close(o[f"scan/{tag}/y"], ref[f"scan/{tag}/y"][rows])
        _close(o[f"scan/{tag}/h"], ref[f"scan/{tag}/h"][rows, :][:, chans])
        for k in ("u", "dt", "B", "C"):
            _grad_close(o[f"scan/{tag}/g{k}"], ref[f"scan/{tag}/g{k}"][rows])
    for m in range(shape[1]):
        for k in ("A", "D"):
            got = sum(by[(d, m)][f"scan/{tag}/g{k}"] for d in range(shape[0]))
            _grad_close(got, ref[f"scan/{tag}/g{k}"])


@pytest.mark.parametrize("E", HYB_E)
def test_hybrid_make_loss_fn_under_shard_ctx(runs, E):
    """The sharded step against the reference's (model tolerance: the port's
    unsharded step already differs from the reference's by up to 5.2e-6 of a
    leaf's largest element, Mamba's x_proj, by summation order), and
    against the port's own unsharded step (the layer tolerances)."""
    from repro_torch.common import types
    from repro_torch.common.pytree import tree_paths
    from repro_torch.convert import params_from_jax

    ref, ranks = runs
    cfg = _hybrid_cfg(types, E)
    want = dict(tree_paths(params_from_jax(_nest(ref, f"hyb/{E}/grads"), cfg,
                                           device="cpu")))
    assert cfg.block_period == 2 and any("/moe/" in p for p in want)
    for o in ranks:
        m = int(o["coords"][1])
        _close(o[f"hyb/{E}/loss"], ref[f"hyb/{E}/loss"])
        _close(o[f"hyb/{E}/loss"], o[f"hyb/{E}/loss0"])
        for path, g in want.items():
            g = g.detach().numpy()
            name = path.rsplit("/", 1)[-1]
            if "/moe/w_" in path:
                g = _expert_slice(g, name, E, m, 4)
            got = o[f"hyb/{E}/grads/{path}"]
            np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-5 * np.abs(g).max(),
                                       err_msg=path)
            _grad_close(got, o[f"hyb/{E}/grads0/{path}"])


@pytest.mark.parametrize("E", HYB_E)
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_expert_shards_match_reference_shards(runs, E, shape):
    from repro_torch.common import types
    from repro_torch.common.pytree import tree_paths
    from repro_torch.convert import params_from_jax
    from repro_torch.sharding import partition

    ref, _ = runs
    cfg = _hybrid_cfg(types, E)
    params = params_from_jax(_nest(ref, f"hyb/{E}/params"), cfg, device="cpu")

    class StandIn:
        pass

    StandIn.shape = dict(zip(("data", "model"), shape))
    period, seen = cfg.block_period, 0
    for d in range(shape[0]):
        for m in range(shape[1]):
            cut = dict(tree_paths(partition.expert_shards(
                params, _assign(partition), StandIn(), coords={"data": d, "model": m})))
            whole = dict(tree_paths(params))
            for path, a in cut.items():
                if "/moe/w_" not in path:
                    assert a is whole[path]           # every other leaf as it is
                    continue
                i, name = int(path.split("/")[1]), path.rsplit("/", 1)[-1]
                shard = ref[f"cut/{E}/{shape[0]}x{shape[1]}/{d}_{m}/blocks/pos{i % period}"
                            f"/moe/{name}"]
                np.testing.assert_array_equal(a.detach().numpy(), shard[i // period])
                assert a.requires_grad and a.is_contiguous()
                seen += 1
    assert seen == shape[0] * shape[1] * 2 * 3        # 2 MoE layers x 3 expert leaves


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), *sys.argv[3:6])
