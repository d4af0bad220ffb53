"""The distributed core on 4 gloo ranks against the reference at 4 forced
host devices.

The reference runs once for the file in a subprocess (its device count is
fixed at jax's first init), writing its inputs and results to an ``.npz``;
then 4 rank processes run the port under gloo on a ``FileStore`` and write
one ``.npz`` each.  No process group starts inside the pytest worker.  Run
alone (~40 s): ``PYTHONPATH=src python -m pytest -q tests/test_torch_dist.py``.

Cases (inputs from one numpy seed):
  * vocab-parallel CE on a (2, 2) ("data", "model") mesh, B 4, S 16, D 32,
    V 64, untied and tied: loss rtol 1e-5; each rank's slice of w and rows
    of h get the reference's dense gradient (rtol 1e-4, atol 1e-6);
  * the Inter-model Communicator (encoder batch over ("data", "model") ->
    LLM batch over ("data",)) and ``explicit_gather_scatter``: values and
    gradients equal the reference's;
  * the pipeline executor at 4 stages x 2 layers of tanh(x @ w), m 4:
    output and every stage's and the input's gradient within 2e-5 of the
    reference's ``pipeline_forward`` and ``jax.grad`` (ratio 1, not p); the
    same layers as 2 stages x 4 on a mesh of listed ranks (1 and 3);
  * a tiny dense decoder's 4 layers through 2 stages (a (2, 2) ("data",
    "stage") mesh: each data row its own pipeline) against the port's
    sequential loop, 1e-5;
  * the tiny MLLM's ``make_loss_fn(communicator=...)`` on each rank against
    the reference's loss over the rank's data rows (1e-5), the encoder's
    gradients summed over the model axis and the LLM's on every rank
    against the reference's gradients over those rows (rtol 1e-4, atol
    1e-4 of each leaf's largest element);
  * ``make_loss_fn(vocab_ce=...)`` of a tiny decoder (untied and tied)
    against the reference's dense loss over the whole batch (1e-5); the
    untied head's vocab slice and the other leaves summed over the data
    axis against the dense gradients (as the MLLM's).
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
B, S, D, V = 4, 16, 32, 64                  # vocab-parallel CE
N_LAYERS, DP, M, MB, SP = 8, 16, 4, 2, 8    # pipeline: layers, width, m, mb, seq
MLLM_ROWS, MAX_MEDIA, MAX_TEXT = 4, 32, 24


def _tiny_mllm(t):
    enc = t.ModelConfig(name="enc-tiny", family="vlm-enc", n_layers=2,
                        d_model=48, n_heads=4, n_kv_heads=4, d_ff=96,
                        vocab_size=0, causal=False, use_rope=False,
                        activation="gelu", input_embed_dim=32,
                        has_lm_head=False, dtype="float32")
    llm = t.ModelConfig(name="llm-tiny", family="dense", n_layers=2,
                        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                        vocab_size=256, dtype="float32")
    return t.MLLMConfig(name="mllm-tiny", encoder=enc, llm=llm,
                        stub=t.ModalityStub("vision", 16, 32),
                        connector_hidden=64, tokens_per_item_out=4)


def _tiny_decoder(t, tied, n_layers=2):
    return t.ModelConfig(name="dec-tiny", family="dense", n_layers=n_layers,
                         d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                         vocab_size=128, tie_embeddings=tied, dtype="float32")


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


# --------------------------------------------------------------------------- #
# The reference (subprocess, 4 forced host devices)
# --------------------------------------------------------------------------- #
def _reference(out_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from repro.common import types as jtypes
    from repro.core.communicator import (explicit_gather_scatter,
                                         make_communicator)
    from repro.core.pipeline.executor import (build_stage_fn, pipeline_forward,
                                              stack_stage_params)
    from repro.data.synthetic import MixedDataset
    from repro.launch.mesh import compat_make_mesh
    from repro.models import mllm as jmllm
    from repro.models import model as jmodel
    from repro.sharding.partition import AxisAssignment
    from repro.sharding.vocab_ce import make_vocab_parallel_ce
    from repro.train import step as jstep

    assert jax.device_count() == WORLD
    rng = np.random.default_rng(SEED)
    r = {}
    mesh = compat_make_mesh((2, 2), ("data", "model"))

    # vocab-parallel CE
    r["ce/h"] = rng.standard_normal((B, S, D)).astype(np.float32)
    r["ce/labels"] = rng.integers(-1, V, (B, S)).astype(np.int32)
    r["ce/w_untied"] = (rng.standard_normal((D, V)) * 0.1).astype(np.float32)
    r["ce/w_tied"] = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    for tag, tied in (("untied", False), ("tied", True)):
        ce = make_vocab_parallel_ce(mesh, ("data",), ("model",), V, tied=tied)
        with mesh:
            loss, (gw, gh) = jax.jit(jax.value_and_grad(ce, argnums=(0, 1)))(
                jnp.asarray(r[f"ce/w_{tag}"]), jnp.asarray(r["ce/h"]),
                jnp.asarray(r["ce/labels"]))
        r[f"ce/loss_{tag}"], r[f"ce/gw_{tag}"], r[f"ce/gh_{tag}"] = (
            np.asarray(loss), np.asarray(gw), np.asarray(gh))

    # communicator and explicit gather/scatter
    x = rng.standard_normal((8, 6, 16)).astype(np.float32)
    g = rng.standard_normal((8, 6, 16)).astype(np.float32)
    r["comm/x"], r["comm/g"] = x, g
    comm = make_communicator(mesh, AxisAssignment(batch=("data", "model"), tensor=()),
                             AxisAssignment(batch=("data",), tensor=("model",)))
    egs = explicit_gather_scatter(mesh, "data")
    with mesh:
        xs = jax.device_put(x, NamedSharding(mesh, JP(("data", "model"))))
        r["comm/y"] = np.asarray(jax.jit(comm)(xs))
        r["comm/gx"] = np.asarray(jax.jit(jax.grad(
            lambda v: jnp.sum(comm(v) * g)))(xs))
        xd = jax.device_put(x, NamedSharding(mesh, JP("data")))
        r["egs/y"] = np.asarray(egs(xd))
        r["egs/gx"] = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(egs(v) * g)))(xd))

    # pipeline executor: 4 stages x 2 layers of tanh(x @ w)
    smesh = compat_make_mesh((WORLD,), ("stage",))
    W = (rng.standard_normal((N_LAYERS, DP, DP)) * DP ** -0.5).astype(np.float32)
    xs = rng.standard_normal((M, MB, SP, DP)).astype(np.float32)
    cot = rng.standard_normal((M, MB, SP, DP)).astype(np.float32)
    r["pipe/W"], r["pipe/xs"], r["pipe/cot"] = W, xs, cot
    pipe = pipeline_forward(smesh, build_stage_fn(lambda w, h: jnp.tanh(h @ w), 2))
    stacked = jax.device_put(stack_stage_params(jnp.asarray(W), WORLD),
                             NamedSharding(smesh, JP("stage")))
    with smesh:
        r["pipe/out"] = np.asarray(jax.jit(pipe)(stacked, jnp.asarray(xs)))
        gW, gx = jax.jit(jax.grad(lambda w, v: jnp.sum(pipe(w, v) * cot), argnums=(0, 1)))(
            stacked, jnp.asarray(xs))
    r["pipe/gW"], r["pipe/gxs"] = np.asarray(gW), np.asarray(gx)

    # the tiny MLLM: loss and gradients over each data rank's rows
    jcfg = _tiny_mllm(jtypes)
    ds = MixedDataset("mixed", seed=SEED, tokens_per_media_item=8)
    batch = ds.materialize(ds.sample(MLLM_ROWS), embed_dim=32, vocab_size=256,
                           max_media=MAX_MEDIA, max_text=MAX_TEXT, seed=SEED)
    params = jax.jit(jmllm.init, static_argnums=1)(jax.random.PRNGKey(SEED), jcfg)
    r.update(_flat(jax.tree.map(np.asarray, params), "mllm/params"))
    r.update({f"mllm/batch/{k}": v for k, v in batch.items()})
    loss_fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(
        jcfg, jmodel.FwdCtx(mode="train", attn_impl="naive"))))
    for d in range(2):
        mb = {k: jnp.asarray(v[2 * d:2 * d + 2]) for k, v in batch.items()}
        loss, grads = loss_fn(params, mb)
        r[f"mllm/loss{d}"] = np.asarray(loss)
        r.update(_flat(jax.tree.map(np.asarray, grads), f"mllm/grads{d}"))

    # make_loss_fn's dense loss for the vocab_ce hook
    toks = rng.integers(0, 128, (4, S)).astype(np.int32)
    labels = rng.integers(-1, 128, (4, S)).astype(np.int32)
    r["dec/tokens"], r["dec/labels"] = toks, labels
    for tag, tied in (("untied", False), ("tied", True)):
        cfg = _tiny_decoder(jtypes, tied)
        p = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(SEED + 1), cfg)
        r.update(_flat(jax.tree.map(np.asarray, p), f"dec/{tag}/params"))
        loss, grads = jax.jit(jax.value_and_grad(jstep.make_loss_fn(
            cfg, jmodel.FwdCtx(mode="train", attn_impl="naive"))))(
            p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        r[f"dec/{tag}/loss"] = np.asarray(loss)
        r.update(_flat(jax.tree.map(np.asarray, grads), f"dec/{tag}/grads"))
    np.savez(out_path, **r)


# --------------------------------------------------------------------------- #
# The port (one process a rank, gloo)
# --------------------------------------------------------------------------- #
def _rank(rank, store_path, ref_path, out_path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.common import types
    from repro_torch.common.pytree import tree_leaves, tree_map, tree_paths
    from repro_torch.convert import params_from_jax
    from repro_torch.core.communicator import (explicit_gather_scatter,
                                               make_communicator)
    from repro_torch.core.pipeline.executor import (build_stage_fn, pipeline_forward,
                                                    stack_layers, stack_stage_params)
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import model
    from repro_torch.models.model import FwdCtx
    from repro_torch.sharding.partition import AxisAssignment
    from repro_torch.sharding.vocab_ce import make_vocab_parallel_ce
    from repro_torch.train import step

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    ref = dict(np.load(ref_path))
    t = lambda a: torch.tensor(np.asarray(a))                        # noqa: E731
    leaf = lambda a: t(a).requires_grad_(True)                        # noqa: E731
    out = {}
    try:
        mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
        d, m = mesh.get_local_rank("data"), mesh.get_local_rank("model")

        # vocab-parallel CE: this rank's rows of h and vocab slice of w
        rows = slice(2 * d, 2 * d + 2)
        for tag, tied in (("untied", False), ("tied", True)):
            ce = make_vocab_parallel_ce(mesh, ("data",), ("model",), V, tied=tied)
            vs = slice(m * V // 2, (m + 1) * V // 2)
            w = leaf(ref[f"ce/w_{tag}"][vs] if tied else ref[f"ce/w_{tag}"][:, vs])
            h = leaf(ref["ce/h"][rows])
            loss = ce(w, h, t(ref["ce/labels"][rows]))
            loss.backward()
            out[f"ce/loss_{tag}"] = loss.detach().numpy()
            out[f"ce/gw_{tag}"], out[f"ce/gh_{tag}"] = w.grad.numpy(), h.grad.numpy()
        # the full table: its gradient is the dense one's slice, zeros elsewhere
        ce = make_vocab_parallel_ce(mesh, ("data",), ("model",), V, tied=True)
        w = leaf(ref["ce/w_tied"])
        ce(w, t(ref["ce/h"][rows]), t(ref["ce/labels"][rows])).backward()
        out["ce/gw_full"] = w.grad.numpy()
        out["ce/none"] = np.array([
            make_vocab_parallel_ce(mesh, ("data",), (), V, False) is None,
            make_vocab_parallel_ce(mesh, ("data",), ("model",), V + 1, False) is None,
            make_vocab_parallel_ce(make_host_mesh((4, 1), ("data", "model"),
                                                  device_type="cpu"),
                                   ("data",), ("model",), V, False) is None])

        # communicator: encoder rows over (data, model) -> LLM rows over data
        comm = make_communicator(mesh, AxisAssignment(batch=("data", "model"), tensor=()),
                                 AxisAssignment(batch=("data",), tensor=("model",)))
        e = 2 * d + m
        x = leaf(ref["comm/x"][2 * e:2 * e + 2])
        y = comm(x)
        (y * t(ref["comm/g"][4 * d:4 * d + 4])).sum().backward()
        out["comm/y"], out["comm/gx"] = y.detach().numpy(), x.grad.numpy()
        x = leaf(ref["comm/x"][4 * d:4 * d + 4])
        y = explicit_gather_scatter(mesh, "data")(x)
        (y * t(ref["comm/g"][4 * d:4 * d + 4])).sum().backward()
        out["egs/y"], out["egs/gx"] = y.detach().numpy(), x.grad.numpy()

        # pipeline executor: 4 stages x 2 layers
        smesh = make_mesh((WORLD,), ("stage",), device_type="cpu")
        stacked = stack_stage_params(t(ref["pipe/W"]), WORLD).requires_grad_(True)
        xs = leaf(ref["pipe/xs"])
        pipe = pipeline_forward(smesh, build_stage_fn(lambda w, h: torch.tanh(h @ w), 2))
        o = pipe(stacked, xs)
        (o * t(ref["pipe/cot"])).sum().backward()
        out["pipe/out"], out["pipe/gW"], out["pipe/gxs"] = (
            o.detach().numpy(), stacked.grad.numpy(), xs.grad.numpy())
        out["pipe/stage"] = np.array(smesh.get_local_rank("stage"))
        # the same 8 layers as 2 stages x 4 on a mesh of ranks 1 and 3 alone
        sub = make_mesh((2,), ("stage",), ranks=[1, 3], device_type="cpu")
        if rank in (1, 3):
            stacked = stack_stage_params(t(ref["pipe/W"]), 2).requires_grad_(True)
            xs = leaf(ref["pipe/xs"])
            o = pipeline_forward(sub, build_stage_fn(lambda w, h: torch.tanh(h @ w), 4))(
                stacked, xs)
            (o * t(ref["pipe/cot"])).sum().backward()
            s = sub.get_local_rank("stage")
            out["sub/stage"] = np.array(s)
            out["sub/out"], out["sub/gW"], out["sub/gxs"] = (
                o.detach().numpy(), stacked.grad[s].numpy(), xs.grad.numpy())

        # a tiny decoder's 4 layers through 2 stages, each data row its own
        # pipeline, against the sequential loop over the same layers
        cfg = _tiny_decoder(types, False, n_layers=4)
        pmesh = make_mesh((2, 2), ("data", "stage"), device_type="cpu")
        gen = np.random.default_rng(100 + pmesh.get_local_rank("data"))
        mbs = leaf(gen.standard_normal((3, 2, 12, cfg.d_model)).astype(np.float32))
        seg = torch.tensor([[1] * 5 + [2] * 7, [1] * 9 + [0] * 3] * 3).reshape(3, 2, 12)
        pos = torch.tensor([list(range(5)) + list(range(7)), list(range(12))] * 3
                           ).reshape(3, 2, 12)
        layers = model.init(cfg, seed=3, device="cpu")["layers"]
        flat = stack_layers([tree_map(lambda a: a.detach(), lp) for lp in layers])
        stacked = tree_map(lambda a: a.requires_grad_(True), stack_stage_params(flat, 2))
        fn = model.layer_fn(cfg, FwdCtx(attn_impl="kernel"))
        o = pipeline_forward(pmesh, build_stage_fn(fn, 2))(stacked, mbs, pos, seg)
        cot = torch.tensor(gen.standard_normal(tuple(o.shape)).astype(np.float32))
        (o * cot).sum().backward()
        got = [o.detach(), mbs.grad.clone()] + [a.grad[pmesh.get_local_rank("stage")]
                                                for a in tree_leaves(stacked)]
        mbs.grad = None
        seq = tree_map(lambda a: a.detach().requires_grad_(True), flat)
        outs = []
        for i in range(3):
            h = mbs[i]
            for layer in range(4):
                h = fn(tree_map(lambda a: a[layer], seq), h, pos[i], seg[i])
            outs.append(h)
        o2 = torch.stack(outs)
        (o2 * cot).sum().backward()
        s = pmesh.get_local_rank("stage")
        want = [o2.detach(), mbs.grad] + [a.grad.reshape(2, 2, *a.shape[1:])[s]
                                          for a in tree_leaves(seq)]
        out["dec_pipe/err"] = np.array([
            float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
            for a, b in zip(got, want)])

        # the tiny MLLM through the communicator hook
        mcfg = _tiny_mllm(types)
        mp = params_from_jax(_nest(ref, "mllm/params"), mcfg, device="cpu")
        batch = _nest(ref, "mllm/batch")
        mb = {k: t(v[e:e + 1] if k.startswith("media") else v[rows])
              for k, v in batch.items()}
        loss = step.make_loss_fn(mcfg, FwdCtx(attn_impl="kernel"),
                                 communicator=comm)(mp, mb)
        loss.backward()
        out["mllm/loss"] = loss.detach().numpy()
        for path, p in tree_paths(mp):
            g = p.grad.clone()
            if path.startswith("encoder/"):          # this rank's media rows
                dist.all_reduce(g, group=mesh.get_group("model"))
            out[f"mllm/grads/{path}"] = g.numpy()

        # make_loss_fn(vocab_ce=...): this data rank's rows, the vocab sharded
        for tag, tied in (("untied", False), ("tied", True)):
            dcfg = _tiny_decoder(types, tied)
            dp = params_from_jax(_nest(ref, f"dec/{tag}/params"), dcfg, device="cpu")
            ce = make_vocab_parallel_ce(mesh, ("data",), ("model",), 128, tied=tied)
            loss = step.make_loss_fn(dcfg, FwdCtx(attn_impl="kernel"), vocab_ce=ce)(
                dp, {"tokens": t(ref["dec/tokens"][rows]),
                     "labels": t(ref["dec/labels"][rows])})
            loss.backward()
            out[f"dec/{tag}/loss"] = loss.detach().numpy()
            for path, p in tree_paths(dp):
                out[f"dec/{tag}/grads/{path}"] = p.grad.numpy()
        out["coords"] = np.array([d, m])
    finally:
        dist.destroy_process_group()
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
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


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _grad_close(got, want):
    """A model's gradient leaf: rtol 1e-4, atol 1e-4 of the leaf's largest
    element (the two packages sum in other orders; an element that cancels
    to 1e-3 of the leaf's scale may differ by 1e-6 in fp32)."""
    _close(got, want, 1e-4, 1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("tag", ["untied", "tied"])
def test_vocab_parallel_ce_matches_dense(runs, tag):
    ref, ranks = runs
    for out in ranks:
        d, m = out["coords"]
        _close(out[f"ce/loss_{tag}"], ref[f"ce/loss_{tag}"], 1e-5)
        vs = slice(m * V // 2, (m + 1) * V // 2)
        gw = ref[f"ce/gw_{tag}"]
        _close(out[f"ce/gw_{tag}"], gw[vs] if tag == "tied" else gw[:, vs], 1e-4, 1e-6)
        _close(out[f"ce/gh_{tag}"], ref[f"ce/gh_{tag}"][2 * d:2 * d + 2], 1e-4, 1e-6)


def test_vocab_parallel_ce_full_table_and_none(runs):
    ref, ranks = runs
    for out in ranks:
        m = out["coords"][1]
        want = np.zeros_like(ref["ce/gw_tied"])
        vs = slice(m * V // 2, (m + 1) * V // 2)
        want[vs] = ref["ce/gw_tied"][vs]
        _close(out["ce/gw_full"], want, 1e-4, 1e-6)
        # no model axes, a vocab the model size does not divide, model size 1
        assert out["ce/none"].tolist() == [True, True, True]


def test_inter_model_communicator_preserves_values(runs):
    ref, ranks = runs
    for out in ranks:
        d, m = out["coords"]
        e = 2 * d + m
        np.testing.assert_array_equal(out["comm/y"], ref["comm/y"][4 * d:4 * d + 4])
        np.testing.assert_array_equal(out["comm/y"], ref["comm/x"][4 * d:4 * d + 4])
        # the reverse reshard: each encoder row's gradient once, not summed
        np.testing.assert_array_equal(out["comm/gx"], ref["comm/gx"][2 * e:2 * e + 2])
        np.testing.assert_array_equal(out["comm/gx"], ref["comm/g"][2 * e:2 * e + 2])


def test_explicit_gather_scatter(runs):
    ref, ranks = runs
    for out in ranks:
        d = out["coords"][0]
        np.testing.assert_array_equal(out["egs/y"], ref["egs/y"][4 * d:4 * d + 4])
        np.testing.assert_array_equal(out["egs/gx"], ref["egs/gx"][4 * d:4 * d + 4])


def test_pipeline_executor_matches_sequential(runs):
    ref, ranks = runs
    for out in ranks:
        s = int(out["pipe/stage"])
        _close(out["pipe/out"], ref["pipe/out"], 2e-5, 2e-5)
        _close(out["pipe/gxs"], ref["pipe/gxs"], 2e-5, 2e-5)
        _close(out["pipe/gW"][s], ref["pipe/gW"][s], 2e-5, 2e-5)
        ratio = np.linalg.norm(out["pipe/gW"][s]) / np.linalg.norm(ref["pipe/gW"][s])
        assert abs(ratio - 1) < 1e-5, ratio
        # the other stages' slots of this rank's stacked leaf get nothing
        others = np.delete(out["pipe/gW"], s, axis=0)
        assert not others.any()
    # sequential composition of the same layers
    h = ref["pipe/xs"].astype(np.float64)
    for w in ref["pipe/W"]:
        h = np.tanh(h @ w)
    _close(ranks[0]["pipe/out"], h, 2e-5, 2e-5)


def test_pipeline_on_a_mesh_of_listed_ranks(runs):
    ref, ranks = runs
    gW = ref["pipe/gW"].reshape(2, 4, DP, DP)            # 4 stages x 2 -> 2 x 4
    for k, out in enumerate(ranks):
        if k not in (1, 3):
            assert "sub/out" not in out
            continue
        s = int(out["sub/stage"])
        assert s == (k - 1) // 2
        _close(out["sub/out"], ref["pipe/out"], 2e-5, 2e-5)
        _close(out["sub/gxs"], ref["pipe/gxs"], 2e-5, 2e-5)
        _close(out["sub/gW"], gW[s], 2e-5, 2e-5)


def test_stack_stage_params_from_p():
    import jax.numpy as jnp
    import torch

    from repro.core.pipeline import executor as jexec
    from repro_torch.core.pipeline import executor

    W = np.random.default_rng(SEED).standard_normal((8, 3, 5)).astype(np.float32)
    tree = {"w": W, "b": W[:, 0]}
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    pt = {k: torch.tensor(v) for k, v in tree.items()}
    for p, from_p in ((4, None), (2, 4), (8, 2), (1, 8), (2, 1)):
        jt = jexec.stack_stage_params(jt, p, from_p=from_p)
        pt = executor.stack_stage_params(pt, p, from_p=from_p)
        for k in tree:
            np.testing.assert_array_equal(pt[k].numpy(), np.asarray(jt[k]))
    for k in tree:
        np.testing.assert_array_equal(executor.unstack_stage_params(pt)[k].numpy(),
                                      tree[k])
    with pytest.raises(ValueError, match="from_p"):
        executor.stack_stage_params(pt, 4, from_p=4)
    with pytest.raises(ValueError, match="not divisible"):
        executor.stack_stage_params({"w": torch.zeros(6, 2)}, 4)


def test_decoder_layers_through_two_stages(runs):
    _, ranks = runs
    for out in ranks:
        # output, microbatch gradient, then every leaf of the rank's stage
        assert out["dec_pipe/err"].max() <= 1e-5, out["dec_pipe/err"]


def test_mllm_loss_with_communicator_per_data_rank(runs):
    from repro_torch.common import types
    from repro_torch.common.pytree import tree_paths
    from repro_torch.convert import params_from_jax

    ref, ranks = runs
    mcfg = _tiny_mllm(types)
    for out in ranks:
        d = out["coords"][0]
        _close(out["mllm/loss"], ref[f"mllm/loss{d}"], 1e-5)
        want = params_from_jax(_nest(ref, f"mllm/grads{d}"), mcfg, device="cpu")
        for path, g in tree_paths(want):
            _grad_close(out[f"mllm/grads/{path}"], g.detach().numpy())


@pytest.mark.parametrize("tag", ["untied", "tied"])
def test_make_loss_fn_vocab_ce_matches_dense(runs, tag):
    from repro_torch.common import types
    from repro_torch.common.pytree import tree_paths
    from repro_torch.convert import params_from_jax

    ref, ranks = runs
    dense = dict(tree_paths(params_from_jax(
        _nest(ref, f"dec/{tag}/grads"), _tiny_decoder(types, tag == "tied"),
        device="cpu")))
    for out in ranks:
        _close(out[f"dec/{tag}/loss"], ref[f"dec/{tag}/loss"], 1e-5)
    by = {tuple(o["coords"]): o for o in ranks}
    for path, g in dense.items():
        g = g.detach().numpy()
        if path == "embed/w" and tag == "tied":
            continue              # lookup (rows of a data rank) + head (a slice)
        for m in range(2):
            got = [by[(d, m)][f"dec/{tag}/grads/{path}"] for d in range(2)]
            if path == "unembed/w":
                vs = slice(m * 64, (m + 1) * 64)
                _grad_close(got[0][:, vs], g[:, vs])
            else:
                _grad_close(got[0] + got[1], g)


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference(sys.argv[2])
    else:
        _rank(int(sys.argv[2]), *sys.argv[3:6])
