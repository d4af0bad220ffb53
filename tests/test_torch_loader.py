"""The port's ``ScheduledLoader`` and quickstart against the reference, on
the CPU.

The loader is numpy: the same seeded dataset and scheduler must give equal
packed batches, with prefetch on and off.  The schedulers run with a time
limit the branch-and-bound search never reaches on these instances (8 items
in 4 buckets), and every batch asserts ``solver == "ilp"`` on both sides.

The quickstart's tiny path (``--tiny --device cpu``) trains 2 steps on
weights made by the reference (``params_from_jax``); the reference's
``make_train_step`` takes the same packed batches.  Tolerances are
``tests/test_torch_train.py``'s: losses and parameters 1e-4, and each
update p_n − p_0 within 0.1 lr of the reference's at lr 1e-4.  As in
``tests/test_torch_llava.py``, an element whose first reference gradient is
below GRAD_NOISE but not zero is left out of the update comparison: its
sign and size are fp32 rounding, and Adam moves it by up to lr a step all
the same.  Those elements must stay under 0.1 % of all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.core.engine import DFLOPEngine as JEngine
from repro.core.optimizer import space as jspace
from repro.core.profiling import analytic as jan
from repro.data.loader import ScheduledLoader as JScheduledLoader
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.models import model as jmodel
from repro.models.model import FwdCtx as JFwdCtx
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch import quickstart
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer import space
from repro_torch.core.profiling import analytic as an
from repro_torch.data.loader import ScheduledLoader
from repro_torch.data.synthetic import MixedDataset

torch.set_num_threads(1)

TPM, GBS, BUDGET, VOCAB = 8, 8, 256, 512
TOL = 1e-4
# Above the fp32 disagreement of the two packages' first gradients (at
# most 2.05e-7 here, against a largest gradient of 0.109); the updates that
# differ past 0.1 lr all sit on gradients of 2e-10 to 9e-8.
GRAD_NOISE = 3e-7
KEYS = ("tokens", "labels", "segment_ids", "positions")
LLM = types.ModelConfig(name="llm-tiny", family="dense", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=VOCAB,
                        dtype="float32")


def _ref_cfg(cfg):
    return jtypes.ModelConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(types.ModelConfig)})


def _schedulers():
    """The same plan (N_mb 2, dp 2: 4 buckets) on both sides, priced by the
    reference's V5E spec."""
    cl = dict(n_chips=4, chips_per_node=4)
    eng = DFLOPEngine(llm_cfg=LLM, cluster=space.ClusterSpec(**cl),
                      tokens_per_media_item=TPM, backend=an.AnalyticBackend(an.V5E))
    jeng = JEngine(llm_cfg=_ref_cfg(LLM), cluster=jspace.ClusterSpec(**cl),
                   tokens_per_media_item=TPM, backend=jan.AnalyticBackend(jan.V5E))
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=TPM), n_samples=256)
    jeng.profile(JMixedDataset("mixed", seed=0, tokens_per_media_item=TPM), n_samples=256)
    plan = space.ParallelismPlan(llm=space.ModuleParallelism(1, 1, 2), n_mb=2)
    jplan = jspace.ParallelismPlan(llm=jspace.ModuleParallelism(1, 1, 2), n_mb=2)
    return (eng.scheduler(plan=plan, ilp_time_limit_s=60.0),
            jeng.scheduler(plan=jplan, ilp_time_limit_s=60.0))


class _WindowComposer:
    """A duck-typed composer (``push``/``ready``/``compose``/``drain``):
    holds two draws and emits their items sorted by text length, ``GBS`` at
    a time.  It stands in for the reference's ``LookaheadComposer`` to drive
    the loader's composition paths, inline and on the compose thread."""

    def __init__(self):
        self.window = []

    def push(self, items):
        self.window.extend(items)

    @property
    def ready(self):
        return len(self.window) >= 2 * GBS

    def compose(self):
        self.window.sort(key=lambda it: (it.text_len, it.item_id))
        out, self.window = self.window[:GBS], self.window[GBS:]
        return out

    def drain(self):
        while self.window:
            yield self.compose()


def _stream(loader, n=3):
    out = []
    for b in loader:
        out.append((b, loader.last_truncated, loader.last_schedule))
        if len(out) == n:
            return out
    return out


def _assert_equal_streams(got, want):
    assert len(got) == len(want)
    for (b, trunc, sc), (jb, jtrunc, jsc) in zip(got, want):
        for k in KEYS:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        assert trunc == jtrunc
        assert sc.groups == jsc.groups
        if sc.solver != "random":
            assert sc.solver == jsc.solver == "ilp"


@pytest.mark.parametrize("random_baseline", [False, True], ids=["ilp", "random"])
@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_loader_matches_reference(prefetch, random_baseline):
    sched, jsched = _schedulers()
    kw = dict(gbs=GBS, token_budget=BUDGET, vocab_size=VOCAB, seed=3, prefetch=prefetch,
              random_baseline=random_baseline)
    got = _stream(ScheduledLoader(MixedDataset("mixed", seed=7, tokens_per_media_item=TPM),
                                  sched, **kw))
    want = _stream(JScheduledLoader(JMixedDataset("mixed", seed=7, tokens_per_media_item=TPM),
                                    jsched, **kw))
    _assert_equal_streams(got, want)
    assert got[0][0]["tokens"].shape == (2, 2, BUDGET)
    assert any(t > 0 for _, t, _ in got)          # the budget truncates some rows


@pytest.mark.parametrize("compose_prefetch", [False, True], ids=["inline", "thread"])
def test_loader_composer_paths_match_reference(compose_prefetch):
    """A finite item source through a composer: every item once, the same
    batches as the reference's loader on the same composer."""
    sched, jsched = _schedulers()
    items = MixedDataset("mixed", seed=9, tokens_per_media_item=TPM).sample(5 * GBS)
    jitems = JMixedDataset("mixed", seed=9, tokens_per_media_item=TPM).sample(5 * GBS)
    kw = dict(gbs=GBS, token_budget=BUDGET, vocab_size=VOCAB, seed=1,
              compose_prefetch=compose_prefetch)
    got = _stream(ScheduledLoader(None, sched, composer=_WindowComposer(),
                                  item_source=[items[i:i + GBS] for i in range(0, 5 * GBS, GBS)],
                                  **kw), n=99)
    want = _stream(JScheduledLoader(None, jsched, composer=_WindowComposer(),
                                    item_source=[jitems[i:i + GBS]
                                                 for i in range(0, 5 * GBS, GBS)], **kw), n=99)
    assert len(got) == 5
    _assert_equal_streams(got, want)


class _Recorder:
    """The loader, keeping every batch it yields."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __iter__(self):
        for b in self.loader:
            self.batches.append(b)
            yield b

    def __getattr__(self, name):
        return getattr(self.loader, name)


def test_quickstart_tiny_tracks_reference():
    sizes, lr = quickstart.TINY, 1e-4
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=sizes.tokens_per_media_item)
    eng, res, _, _ = quickstart.plan(sizes, ds)
    assert res.found
    loader = _Recorder(quickstart.make_loader(sizes, eng, ds))
    jcfg = _ref_cfg(sizes.cfg)
    jp = jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), sizes.cfg, device="cpu")
    p0 = [p.detach().clone() for p in tree_leaves(params)]
    records = []
    for params, r in quickstart.train(sizes, loader, steps=2, device="cpu", lr=lr,
                                      params=params):
        records.append(r)
    assert len(records) == len(loader.batches) == 2
    for r, b in zip(records, loader.batches):
        assert sorted(i for g in r["schedule"].groups for i in g) == list(range(sizes.gbs))
        assert r["peak_gib"] is None and np.isfinite(r["schedule"].step_makespan)
        assert r["row_tokens"] == (b["segment_ids"] > 0).sum(-1).ravel().tolist()
    jctx = JFwdCtx(mode="train", attn_impl="naive")
    # the reference's first gradient, the mean over the step's microbatches
    jgrad = jax.jit(jax.grad(jstep.make_loss_fn(jcfg, jctx)))
    n_mb = quickstart.LOCAL_PLAN.n_mb
    g1 = [jgrad(jp, jax.tree.map(lambda x, i=i: jnp.asarray(x[i]), loader.batches[0]))
          for i in range(n_mb)]
    g1 = params_from_jax(jax.tree.map(lambda *g: sum(map(np.asarray, g)) / n_mb, *g1),
                         sizes.cfg, device="cpu")
    jtrain = jax.jit(jstep.make_train_step(jcfg, joptim.AdamWConfig(lr=lr), ctx=jctx))
    jopt = joptim.adamw_init(jp)
    for b, r in zip(loader.batches, records):
        assert b["tokens"].shape == (quickstart.LOCAL_PLAN.n_mb, 1, sizes.token_budget)
        jp, jopt, jm = jtrain(jp, jopt, jax.tree.map(jnp.asarray, b), lr)
        np.testing.assert_allclose(r["loss"], float(jm["loss"]), rtol=TOL, atol=TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jp), sizes.cfg, device="cpu")
    n_noise = n_all = 0
    for a, b, q0, g in zip(tree_leaves(params), tree_leaves(want), p0, tree_leaves(g1)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL)
        keep = ~((g != 0) & (g.abs() < GRAD_NOISE))
        n_noise += int((~keep).sum())
        n_all += keep.numel()
        got, ref = (a.detach() - q0)[keep], (b.detach() - q0)[keep]
        assert ref.abs().max() > lr           # the reference's weights moved
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0.1 * lr)
    assert n_noise <= 1e-3 * n_all, (n_noise, n_all)


def test_quickstart_cli_tiny_on_cpu(capsys):
    assert quickstart.main(["--tiny", "--device", "cpu", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "[plan] tiny on 8 x h100-sxm: theta*=" in out
    assert out.count("step ") == 2 and "[done] 2 steps on cpu" in out
