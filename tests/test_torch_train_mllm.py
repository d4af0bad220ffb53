"""``repro_torch.train_mllm`` (the port's ``examples/train_mllm.py``) and
``train/checkpoint.py`` against the reference, on the CPU.

- The configurations, sizes and ``build_batches`` are the reference's: the
  same items and groups give *equal* batches (the reference's example is
  imported by path).
- Three steps of the tiny MLLM through the controller (``ctl.schedule``),
  from weights made by the reference (``params_from_jax``): the reference's
  jitted ``make_train_step`` takes the batches the port's loop built, with
  the same learning rates.  Tolerances are ``tests/test_torch_train.py``'s:
  losses and parameters 1e-4.
- Checkpoints round-trip bit for bit in fp32 and bf16 (numpy has no bf16:
  its 16 bits are stored raw) and read the reference's files.
- The CLI runs on the CPU in a subprocess; its trace is read back.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.models import mllm as jmllm
from repro.models.model import FwdCtx as JFwdCtx
from repro.train import checkpoint as jcheckpoint
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import train_mllm
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves, tree_paths
from repro_torch.convert import params_from_jax
from repro_torch.core.optimizer import space
from repro_torch.data.synthetic import MixedDataset
from repro_torch.train import checkpoint

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "train_mllm_example", os.path.join(ROOT, "examples", "train_mllm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_example()


def _ref_mcfg(mcfg):
    def cfg(c):
        return jtypes.ModelConfig(**{f.name: getattr(c, f.name)
                                     for f in dataclasses.fields(types.ModelConfig)
                                     if f.name not in types.PORT_ONLY_FIELDS})
    return jtypes.MLLMConfig(
        name=mcfg.name, encoder=cfg(mcfg.encoder), llm=cfg(mcfg.llm),
        stub=jtypes.ModalityStub(**dataclasses.asdict(mcfg.stub)),
        connector_hidden=mcfg.connector_hidden,
        tokens_per_item_out=mcfg.tokens_per_item_out)


def test_configs_and_sizes_match_reference():
    for got, want in ((train_mllm.MCFG, REF.MCFG),
                      (train_mllm.tiny_configs()[2], REF.tiny_configs()[2])):
        assert _ref_mcfg(got) == want
    assert (train_mllm.TPM, train_mllm.GBS, train_mllm.MAX_MEDIA, train_mllm.MAX_TEXT) == \
        (REF.TPM, REF.GBS, REF.MAX_MEDIA, REF.MAX_TEXT)
    assert train_mllm.MCFG.param_count() == _ref_mcfg(train_mllm.MCFG).param_count()


def _plan(sp, dp, n_mb):
    return sp.ParallelismPlan(llm=sp.ModuleParallelism(1, 1, dp),
                              encoder=sp.ModuleParallelism(1, 1, 1), n_mb=n_mb)


@pytest.mark.parametrize("dp,n_mb,layout", [
    (1, 4, [[0, 1, 2], [3, 4], [5, 6, 7, 8, 9], [10]]),
    (2, 2, [[0, 1], [2], [3, 4, 5], [6, 7]]),
    (1, 4, [[0, 1, 2, 3], [], [4], [5, 6]]),          # an empty group
])
def test_build_batches_matches_reference(dp, n_mb, layout):
    from repro.core.optimizer import space as jspace
    items = MixedDataset("mixed", seed=3, tokens_per_media_item=train_mllm.TPM).sample(16)
    jitems = JMixedDataset("mixed", seed=3, tokens_per_media_item=REF.TPM).sample(16)
    assert [it.item_id for it in items] == [it.item_id for it in jitems]
    ds = MixedDataset("video", seed=0, tokens_per_media_item=train_mllm.TPM)
    jds = JMixedDataset("video", seed=0, tokens_per_media_item=REF.TPM)
    for vocab in (train_mllm.LLM.vocab_size, 1024):
        got = train_mllm.build_batches(ds, _plan(space, dp, n_mb), items, layout, n_mb,
                                       vocab_size=vocab)
        want = REF.build_batches(jds, _plan(jspace, dp, n_mb), jitems, layout, n_mb,
                                 vocab_size=vocab)
        assert set(got) == set(want)
        for k in got:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_three_controller_steps_track_reference(tmp_path):
    _, _, mcfg = train_mllm.tiny_configs()
    jcfg = _ref_mcfg(mcfg)
    jp = jax.jit(jmllm.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), mcfg, device="cpu")
    args = train_mllm.parse_args(["--tiny", "--device", "cpu", "--steps", "3",
                                  "--trace", str(tmp_path / "t.json")])
    run = train_mllm.run(args, params=params)
    assert len(run["steps"]) == 3 and run["peak_gib"] is None
    jtrain = jax.jit(jstep.make_train_step(
        jcfg, joptim.AdamWConfig(lr=1e-3), ctx=JFwdCtx(mode="train", attn_impl="naive")))
    jopt = joptim.adamw_init(jp)
    jds = JMixedDataset("mixed", seed=0, tokens_per_media_item=REF.TPM)
    lr_fn = REF.cosine_lr(1e-3, warmup=20, total=3)
    for k, st in enumerate(run["steps"]):
        out = st["schedule"]
        assert out.solver in ("ilp", "ilp-timeout") and out.plan.as_tuple() == \
            run["ctl"].plan.as_tuple()
        assert sorted(i for g in out.groups for i in g) == list(range(train_mllm.GBS))
        batch = REF.build_batches(jds, out.plan, st["items"], out.groups, out.plan.n_mb,
                                  vocab_size=jcfg.llm.vocab_size)
        jp, jopt, jm = jtrain(jp, jopt, batch, lr_fn(k))
        np.testing.assert_allclose(st["loss"], float(jm["loss"]), rtol=TOL, atol=TOL)
        assert st["seconds"] > 0 and not st["in_flight"]
    want = params_from_jax(jax.tree.map(np.asarray, jp), mcfg, device="cpu")
    for a, b in zip(tree_leaves(run["params"]), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL)
    snap = run["ctl"].metrics.snapshot()
    assert (snap["n_schedules"], snap["n_steps"]) == (3, 3)
    assert snap["moe_drop_rate_mean"] is None          # no MoE: NaN is skipped
    names = {e["name"] for e in json.load(open(tmp_path / "t.json"))["traceEvents"]}
    assert {"schedule", "step", "imbalance", "bubble_fraction"} <= names


def _tree(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 5, generator=g).to(dtype).requires_grad_(True),
            "layers": [{"b": torch.randn(7, generator=g).to(dtype)},
                       {"b": torch.randn(7, generator=g).to(dtype) * 1e-30}],
            "s": torch.randn((), generator=g).to(dtype)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_checkpoint_round_trip_is_bitwise(dtype, tmp_path):
    tree = _tree(dtype)
    path = str(tmp_path / "ck" / "params")
    checkpoint.save(path, tree, {"steps": 3, "loss": 1.5})
    meta = checkpoint.load_meta(path)
    assert meta["meta"] == {"steps": 3, "loss": 1.5}
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert set(meta["dtypes"].values()) == {name}
    assert meta["shapes"] == {p: list(t.shape) for p, t in tree_paths(tree)}
    back = checkpoint.restore(path + ".npz", _tree(dtype, seed=1))
    assert [p for p, _ in tree_paths(back)] == [p for p, _ in tree_paths(tree)]
    for (_, a), (_, b) in zip(tree_paths(back), tree_paths(tree)):
        assert a.dtype == b.dtype and a.requires_grad == b.requires_grad
        assert torch.equal(a.detach().view(torch.int16 if dtype == torch.bfloat16
                                           else torch.int32),
                           b.detach().view(torch.int16 if dtype == torch.bfloat16
                                           else torch.int32))
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(path, {**_tree(dtype), "w": torch.zeros(5, 3, dtype=dtype)})
    with pytest.raises(KeyError, match="missing leaf"):
        checkpoint.restore(path, {**_tree(dtype), "extra": torch.zeros(1)})


def test_checkpoint_reads_and_writes_the_reference_layout(tmp_path):
    """A reference checkpoint (bf16 from ml_dtypes, fp32 and an int step)
    restores bit for bit; the reference restores the port's fp32 file (its
    ``restore`` takes array leaves only)."""
    jtree = {"a": jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3) / 7),
             "b": [jnp.asarray(np.linspace(-3, 3, 5), dtype=jnp.bfloat16)],
             "step": 4}
    jcheckpoint.save(str(tmp_path / "ref"), jtree, {"from": "reference"})
    like = {"a": torch.zeros(2, 3), "b": [torch.zeros(5, dtype=torch.bfloat16)], "step": 0}
    back = checkpoint.restore(str(tmp_path / "ref"), like)
    assert back["step"] == 4 and isinstance(back["step"], int)
    np.testing.assert_array_equal(back["a"].numpy(), np.asarray(jtree["a"]))
    assert back["b"][0].view(torch.int16).tolist() == \
        np.asarray(jtree["b"][0]).view(np.int16).tolist()
    assert checkpoint.load_meta(str(tmp_path / "ref"))["meta"] == {"from": "reference"}
    checkpoint.save(str(tmp_path / "port"), {"a": back["a"]}, {"steps": 4})
    jback = jcheckpoint.restore(str(tmp_path / "port"), {"a": jtree["a"]})
    np.testing.assert_array_equal(np.asarray(jback["a"]), np.asarray(jtree["a"]))
    assert jcheckpoint.load_meta(str(tmp_path / "port")) == \
        checkpoint.load_meta(str(tmp_path / "port"))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.kernels import bench
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mllm.main(["--tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.bench_kernel("mamba", (16,))
    with pytest.raises(SystemExit):
        train_mllm.parse_args(["--random", "--replan"])


def test_cli_tiny_on_cpu(tmp_path):
    trace, ckpt = tmp_path / "trace.json", tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.train_mllm", "--tiny", "--device", "cpu",
         "--steps", "8", "--shift-at", "3", "--replan", "--compose-window", "2",
         "--trace", str(trace), "--ckpt", str(ckpt)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    for tag in ("[model]", "step    0", "[dflop] 8 steps", "[runtime]", "[compose] batches=8",
                "chrome trace written", "checkpoint written"):
        assert tag in r.stdout, r.stdout
    doc = json.load(open(trace))
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("step") == 8 and names.count("schedule") == 8
    assert names.count("compose") == 8
    _, _, mcfg = train_mllm.tiny_configs()
    params = checkpoint.restore(str(ckpt), train_mllm.mllm_lib.init(mcfg, device="cpu"))
    assert checkpoint.load_meta(str(ckpt))["meta"]["steps"] == 8
    assert all(torch.isfinite(p).all() for p in tree_leaves(params))
