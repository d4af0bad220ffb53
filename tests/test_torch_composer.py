"""The port's copy of the lookahead batch composer (``data/composer.py``) and
``greedy_bin_pack`` against the reference, on the CPU.

Both are numpy, so composed batches, their ``ComposeStats`` (apart from the
wall-clock ``elapsed_s``) and packed bins must be *equal*.  The schedulers
price with the reference's V5E spec on both sides; items come from the same
seeded ``MixedDataset``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.core.engine import DFLOPEngine as JEngine
from repro.core.optimizer import space as jspace
from repro.core.profiling import analytic as jan
from repro.data import composer as jcomposer
from repro.data.loader import ScheduledLoader as JScheduledLoader
from repro.data.packing import greedy_bin_pack as jgreedy_bin_pack
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro_torch.common import types
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer import space
from repro_torch.core.profiling import analytic as an
from repro_torch.data import composer
from repro_torch.data.loader import ScheduledLoader
from repro_torch.data.packing import greedy_bin_pack
from repro_torch.data.synthetic import MixedDataset

torch.set_num_threads(1)

TPM, GBS, VOCAB = 16, 8, 512
ENC = types.ModelConfig(name="e", family="vlm-enc", n_layers=2, d_model=128,
                        n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=0,
                        causal=False, use_rope=False, input_embed_dim=64,
                        has_lm_head=False)
LLM = types.ModelConfig(name="l", family="dense", n_layers=4, d_model=256,
                        n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=VOCAB)
PLANS = {
    "dp2": dict(llm=(1, 1, 2), encoder=(1, 1, 1), n_mb=2),
    "pp2": dict(llm=(1, 2, 1), encoder=(1, 1, 1), n_mb=4),
    "encoder_fill": dict(llm=(1, 2, 2), encoder=(1, 1, 2), n_mb=2,
                         schedule="encoder_fill"),
}


def _ref_cfg(cfg):
    return jtypes.ModelConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(types.ModelConfig)
                                 if f.name not in types.PORT_ONLY_FIELDS})


def _plan(sp, kw):
    kw = dict(kw)
    enc = kw.pop("encoder")
    return sp.ParallelismPlan(llm=sp.ModuleParallelism(*kw.pop("llm")),
                              encoder=sp.ModuleParallelism(*enc), **kw)


def _schedulers(plan_name="dp2", mode="train"):
    cl = dict(n_chips=16, chips_per_node=8)
    eng = DFLOPEngine(llm_cfg=LLM, enc_cfg=ENC, e_seq_len=16, mode=mode,
                      cluster=space.ClusterSpec(**cl), tokens_per_media_item=TPM,
                      backend=an.AnalyticBackend(an.V5E))
    jeng = JEngine(llm_cfg=_ref_cfg(LLM), enc_cfg=_ref_cfg(ENC), e_seq_len=16, mode=mode,
                   cluster=jspace.ClusterSpec(**cl), tokens_per_media_item=TPM,
                   backend=jan.AnalyticBackend(jan.V5E))
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=TPM), n_samples=256)
    jeng.profile(JMixedDataset("mixed", seed=0, tokens_per_media_item=TPM), n_samples=256)
    kw = PLANS[plan_name]
    return (eng.scheduler(plan=_plan(space, kw), ilp_time_limit_s=0.0),
            jeng.scheduler(plan=_plan(jspace, kw), ilp_time_limit_s=0.0))


def _stats(st):
    d = dataclasses.asdict(st)
    d.pop("elapsed_s")
    return d, st.pred_gain


def _compose_stream(mod, sched, ds_cls, *, n_batches, mixture="mixed", swap_at=None,
                    new_plan=None, **kw):
    comp = mod.LookaheadComposer(sched, gbs=GBS, **kw)
    ds = ds_cls(mixture, seed=4, tokens_per_media_item=TPM)
    out = []
    for b in range(n_batches):
        if b == swap_at:
            sched.set_plan(new_plan)
            if b % 2:
                comp.flush_plan()         # the other half relies on the auto flush
        while not comp.ready:
            comp.push(ds.sample(GBS))
        batch = comp.compose()
        out.append(([it.item_id for it in batch], _stats(comp.last_stats)))
    for batch in comp.drain():
        out.append(([it.item_id for it in batch], _stats(comp.last_stats)))
    return out, comp.n_flushes, comp.pending


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("kw", [dict(window=2), dict(window=4, max_staleness=3),
                                dict(window=3, score="makespan"),
                                dict(window=2, recompile_penalty=0.0, max_candidates=5)],
                         ids=["w2", "w4-s3", "w3-makespan", "w2-nopenalty"])
def test_composed_batches_match_reference(plan_name, kw):
    sched, jsched = _schedulers(plan_name)
    got = _compose_stream(composer, sched, MixedDataset, n_batches=6, **kw)
    want = _compose_stream(jcomposer, jsched, JMixedDataset, n_batches=6, **kw)
    assert got == want
    ids = [i for batch, _ in got[0] for i in batch]
    assert len(ids) == len(set(ids))                    # every item once
    assert got[2] == 0


@pytest.mark.parametrize("swap_at", [2, 3])
def test_composer_reprices_after_plan_swap_like_reference(swap_at):
    sched, jsched = _schedulers("dp2")
    got = _compose_stream(composer, sched, MixedDataset, n_batches=6, window=2,
                          mixture="video", swap_at=swap_at,
                          new_plan=_plan(space, PLANS["pp2"]))
    want = _compose_stream(jcomposer, jsched, JMixedDataset, n_batches=6, window=2,
                           mixture="video", swap_at=swap_at,
                           new_plan=_plan(jspace, PLANS["pp2"]))
    assert got == want
    assert got[1] == swap_at % 2


def test_composer_in_prefill_mode_matches_reference():
    sched, jsched = _schedulers("dp2", mode="prefill")
    assert _compose_stream(composer, sched, MixedDataset, n_batches=4, window=2) == \
        _compose_stream(jcomposer, jsched, JMixedDataset, n_batches=4, window=2)


def test_composer_through_loader_matches_reference():
    """The loader's compose path with the real composer: the same packed
    rows as the reference's loader."""
    sched, jsched = _schedulers("dp2")
    kw = dict(gbs=GBS, token_budget=256, vocab_size=VOCAB, seed=2)
    got = ScheduledLoader(MixedDataset("mixed", seed=5, tokens_per_media_item=TPM), sched,
                          composer=composer.LookaheadComposer(sched, gbs=GBS, window=2),
                          **kw)
    want = JScheduledLoader(JMixedDataset("mixed", seed=5, tokens_per_media_item=TPM),
                            jsched, composer=jcomposer.LookaheadComposer(jsched, gbs=GBS,
                                                                         window=2), **kw)
    for _, b, jb in zip(range(3), got, want):
        for k in ("tokens", "labels", "segment_ids", "positions"):
            np.testing.assert_array_equal(b[k], jb[k])
        assert got.last_schedule.groups == want.last_schedule.groups


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_runs_and_edf_match_reference(seed):
    rng = np.random.default_rng(seed)
    dom = rng.exponential(1.0, 40)
    dom[::7] = dom[0]                                     # ties keep arrival order
    for k, cap in ((1, 64), (5, 64), (8, 4), (40, 64), (41, 64), (0, 8)):
        assert composer.sorted_runs(dom, k, cap) == jcomposer.sorted_runs(dom, k, cap)
    for per_step in (1, 3, 8):
        slack = rng.integers(-2, 12, 30)
        slack[0] = 10 ** 9
        assert composer.edf_forced_count(slack, per_step) == \
            jcomposer.edf_forced_count(slack, per_step)
    assert composer.edf_forced_count([], 4) == 0


def test_composer_validates_like_reference():
    sched, _ = _schedulers("dp2")
    for kw in (dict(window=0), dict(window=3, max_staleness=1), dict(score="x")):
        with pytest.raises(ValueError):
            composer.LookaheadComposer(sched, gbs=GBS, **kw)
    comp = composer.LookaheadComposer(sched, gbs=GBS, window=1)
    comp.push(MixedDataset("mixed", seed=0, tokens_per_media_item=TPM).sample(GBS))
    with pytest.raises(ValueError, match="overfill"):
        comp.push(MixedDataset("mixed", seed=1, tokens_per_media_item=TPM).sample(1))
    with pytest.raises(RuntimeError, match="empty window"):
        composer.LookaheadComposer(sched, gbs=GBS).compose()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_bin_pack_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 3000, size=int(rng.integers(1, 60)))
    lengths[::5] = lengths[0]                             # ties
    for budget in (512, 2048, 8192):
        got = greedy_bin_pack(lengths, budget)
        assert got == jgreedy_bin_pack(lengths, budget)
        assert sorted(i for b in got for i in b) == list(range(len(lengths)))
        assert all(sum(min(int(lengths[i]), budget) for i in b) <= budget for b in got)
    assert greedy_bin_pack([], 16) == jgreedy_bin_pack([], 16) == []
