"""The MoE slice against the reference, fp32 on the CPU: routing, the dense
oracle, the capacity and chunked dispatch paths (outputs, lb loss, stats and
gradients), the MoE stacks of the registry's reduced Granite-MoE, Mixtral
(S above its reduced window of 64) and Jamba with its experts (period 8,
MoE on every other layer), three train steps of each, and the port of
``tests/test_moe_stats.py``.

Same numpy inputs and weights (``params_from_jax``) go through both
packages.  Tolerances are ``test_torch_ssm.py``'s, atol = rtol: 1e-5 for a
layer (routing weights, outputs, lb, stats, gradients), 1e-4 for the model
stacks and three AdamW steps at lr 1e-4 (each update within 0.1 lr, see
``test_torch_train.py`` on Adam).  Routing is held exactly: a flipped
expert fails ``top_e`` equality instead of being averaged away.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.models.layers import moe as jmoe
from repro.runtime.metrics import RuntimeMetrics as JRuntimeMetrics
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import packing
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import model
from repro_torch.models.layers import moe
from repro_torch.runtime.metrics import RuntimeMetrics
from repro_torch.train import optim, step

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

TOL = 1e-5
STACK_TOL = 1e-4
STACK_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x7b", "jamba-v0.1-52b")


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _t(x):
    return torch.tensor(np.array(x))


def _cfgs(**kw):
    """The same tiny MoE ModelConfig in both packages."""
    base = dict(name="moe-tiny", family="moe", n_layers=2, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=64, ffn_pattern=("moe",),
                n_experts=4, top_k=2, dtype="float32", param_dtype="float32")
    base.update(kw)
    return jtypes.ModelConfig(**base), types.ModelConfig(**base)


# Granite's routing shape (40 experts, top 8), Mixtral's (8, top 2) and a
# non-gated activation
LAYER_CFGS = {"e40k8": dict(n_experts=40, top_k=8),
              "e8k2": dict(n_experts=8, top_k=2),
              "e4k2_gelu": dict(activation="gelu")}


def _layer(name, seed=1):
    jcfg, cfg = _cfgs(**LAYER_CFGS[name])
    jp = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, jp, {k: _t(v).requires_grad_(True) for k, v in jp.items()}


# --------------------------------------------------------------------------- #
# The layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(LAYER_CFGS))
def test_route(name):
    jcfg, cfg, jp, p = _layer(name)
    x = _np(0, 96, 32)
    jw, je, jlb = jmoe._route(jp, x, jcfg)
    w, e, lb = moe._route(p, _t(x), cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lb.item(), float(jlb), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(moe._load_imbalance(e, cfg.n_experts).item(),
                               float(jmoe._load_imbalance(je, jcfg.n_experts)),
                               rtol=TOL, atol=TOL)


PATHS = {"dense": (jmoe.apply_dense, moe.apply_dense, {}),
         "capacity_cf0.25": (jmoe.apply_capacity, moe.apply_capacity,
                             dict(capacity_factor=0.25)),
         "capacity_cf1.25": (jmoe.apply_capacity, moe.apply_capacity,
                             dict(capacity_factor=1.25)),
         "capacity_cf2.0": (jmoe.apply_capacity, moe.apply_capacity,
                            dict(capacity_factor=2.0)),
         # 48 tokens in 4 chunks of 12
         "chunked": (jmoe.apply_capacity_chunked, moe.apply_capacity_chunked,
                     dict(capacity_factor=0.5, chunk_tokens=12))}


@pytest.mark.parametrize("name", list(LAYER_CFGS))
@pytest.mark.parametrize("path", list(PATHS))
def test_apply_paths(path, name):
    """Outputs, lb, stats, and the gradients of sum(y · dy) + lb with respect
    to x and every expert leaf."""
    jfn, fn, kw = PATHS[path]
    jcfg, cfg, jp, p = _layer(name)
    x, dy = _np(2, 2, 24, 32), _np(3, 2, 24, 32)

    def jloss(jp, x):
        y, lb, st = jfn(jp, x, jcfg, with_stats=True, **kw)
        return jnp.sum(y * dy) + lb, (y, lb, st)

    (_, (jy, jlb, jst)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, x)
    xt = _t(x).requires_grad_(True)
    y, lb, st = fn(p, xt, cfg, with_stats=True, **kw)
    (torch.sum(y * _t(dy)) + lb).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lb.item(), float(jlb), rtol=TOL, atol=TOL)
    for k in ("drop_rate", "imbalance"):
        np.testing.assert_allclose(st[k].item(), float(jst[k]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=TOL, atol=TOL)
    for k in jp:
        np.testing.assert_allclose(p[k].grad.numpy(), np.asarray(jgp[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    if path == "capacity_cf0.25":
        assert st["drop_rate"].item() > 0.5          # the clip really drops


def test_capacity_is_the_dense_oracle_when_nothing_drops():
    """At capacity_factor = E/k every expert holds every token."""
    _, cfg, _, p = _layer("e8k2")
    x = _t(_np(4, 2, 24, 32))
    yd, lbd = moe.apply_dense(p, x, cfg)
    yc, lbc, st = moe.apply_capacity(p, x, cfg, capacity_factor=8 / 2, with_stats=True)
    assert st["drop_rate"].item() == 0.0
    np.testing.assert_allclose(yc.detach().numpy(), yd.detach().numpy(),
                               rtol=TOL, atol=TOL)
    assert lbc.item() == lbd.item()


def test_chunked_nests_in_a_checkpoint():
    """The chunked path's per-chunk checkpoints inside a layer checkpoint
    (both non-reentrant) give the unchecked path's gradients."""
    _, cfg, _, p = _layer("e8k2")
    x = _t(_np(5, 2, 24, 32))

    def f(x):
        return moe.apply_capacity_chunked(p, x, cfg, capacity_factor=0.5,
                                          chunk_tokens=12)

    grads = []
    for nested in (False, True):
        for q in p.values():
            q.grad = None
        y, lb = (torch.utils.checkpoint.checkpoint(f, x, use_reentrant=False)
                 if nested else f(x))
        (y.square().sum() + lb).backward()
        grads.append([q.grad.clone() for q in p.values()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# The MoE stacks: Granite, Mixtral and Jamba with experts, reduced
# --------------------------------------------------------------------------- #
S = 96                                # above Mixtral's reduced window of 64


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed):
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _stack(arch):
    jcfg, cfg = jget_config(arch).reduced_desc(), get_config(arch).reduced_desc()
    assert any(f == types.FFNKind.MOE for f in cfg.ffn_kinds)
    return jcfg, cfg


def _segments():
    """Two packed rows: segments 1..3 then a padding tail (segment 0)."""
    seg = np.zeros((2, S), np.int32)
    seg[0, :40], seg[0, 40:80] = 1, 2
    seg[1, :30], seg[1, 30:90] = 1, 3
    return seg


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("arch", STACK_ARCHS)
def test_model_forward(arch, cf):
    jcfg, cfg = _stack(arch)
    if arch == "mixtral-8x7b":
        assert cfg.attention_kind == "sliding" and cfg.window_size == 64 < S
    jp = _jax_params(jcfg, 3)
    toks = np.random.default_rng(14).integers(1, cfg.vocab_size, (2, S)).astype(np.int32)
    seg = _segments()
    want, _, jaux = jax.jit(lambda p: jmodel.forward(
        p, jcfg, tokens=toks, segment_ids=jnp.asarray(seg),
        ctx=jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="xla",
                          capacity_factor=cf)))(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    got, _, aux = model.forward(params, cfg, tokens=_t(toks), segment_ids=_t(seg),
                                ctx=model.FwdCtx(attn_block=8, capacity_factor=cf))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=STACK_TOL, atol=STACK_TOL)
    for k in ("lb_loss", "moe_drop_rate", "moe_imbalance"):
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]),
                                   rtol=STACK_TOL, atol=STACK_TOL, err_msg=k)
    if cf < 1:
        assert aux["moe_drop_rate"].item() > 0


def test_drop_rate_is_divided_by_n_blocks_as_in_reference():
    """The reference's quirk (ROADMAP Queue 3 fault 2): 4 layers, MoE on
    every layer (period 1, 4 blocks), 4 experts, top 2, T 32 and capacity
    factor 0.25 keep at most 4 · 4 = 16 of 64 assignments a layer, so every
    layer drops at least 0.75; both packages report the mean over layers
    divided by n_blocks = 4."""
    jcfg, cfg = _cfgs(n_layers=4)
    jp = _jax_params(jcfg, 0)
    toks = np.random.default_rng(1).integers(1, 64, (1, 32)).astype(np.int32)
    _, _, jaux = jmodel.forward(jp, jcfg, tokens=toks, ctx=jmodel.FwdCtx(
        mode="train", attn_impl="naive", capacity_factor=0.25))
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    _, _, aux = model.forward(params, cfg, tokens=_t(toks),
                              ctx=model.FwdCtx(capacity_factor=0.25))
    drop = aux["moe_drop_rate"].item()
    assert drop == pytest.approx(float(jaux["moe_drop_rate"]), abs=1e-7)
    assert 0.75 / 4 <= drop <= 0.25


def _packed(cfg, n_steps, n_mb=2, rows=2, tpm=4):
    """``n_steps`` batches of n_mb x rows packed rows of S tokens (the port's
    ``pack_items``, held equal to the reference's in test_torch_ssm.py)."""
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=tpm)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n_steps):
        packed = [packing.pack_items(ds.sample(6), S, tpm, cfg.vocab_size, rng)
                  for _ in range(n_mb * rows)]
        out.append({k: np.stack([getattr(pb, k)[0] for pb in packed]).reshape(
            n_mb, rows, S) for k in ("tokens", "labels", "segment_ids", "positions")})
    return out


def track_reference(jcfg, cfg, jp, batches, jctx, ctx, lr=1e-4):
    """Train ``cfg`` (a decoder, an encoder-only model or an MLLM) from the
    reference's params ``jp`` on numpy ``batches`` in both packages, with
    AdamW at ``lr``.  Losses and MoE stats within 1e-4 at every step; then
    parameters within 1e-4 and each update within 0.1 lr.  An element may
    miss only where the two packages' gradients differ by more than 5 % of
    the reference's at some step: Adam moves a weight by about lr whatever
    its gradient's size, so where fp32 rounding decides a near-zero
    gradient's sign or size it decides the update (a few embedding and
    projection elements of the reduced, 8-layer Jamba, whose gradients
    differ by up to 5e-5 at step 3, dense FFNs or not); such misses must
    stay rare.  Returns the port's per-step metrics."""
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jtrain = jax.jit(jstep.make_train_step(jcfg, joptim.AdamWConfig(lr=lr), ctx=jctx))
    jgrad = jax.jit(jax.grad(jstep.make_loss_fn(jcfg, jctx)))
    train = step.make_train_step(cfg, optim.AdamWConfig(lr=lr), ctx=ctx)
    loss_fn = step.make_loss_fn(cfg, ctx)
    jopt, opt = joptim.adamw_init(jp), optim.adamw_init(params)
    p0 = [p.detach().clone() for p in tree_leaves(params)]
    unstable = [torch.zeros(p.shape, dtype=torch.bool) for p in p0]
    metrics = []
    for b in batches:
        bt = step.as_tensors(b, device="cpu")
        n_mb = len(next(iter(b.values())))
        # this step's gradients in both packages (sums over microbatches)
        jg = [jgrad(jp, jax.tree.map(lambda x, i=i: jnp.asarray(x[i]), b))
              for i in range(n_mb)]
        jg = params_from_jax(jax.tree.map(lambda *a: sum(map(np.asarray, a)), *jg),
                             cfg, device="cpu")
        for i in range(n_mb):
            loss_fn(params, {k: v[i] for k, v in bt.items()}).backward()
        for u, p, g in zip(unstable, tree_leaves(params), tree_leaves(jg)):
            u |= (p.grad - g).abs() > 0.05 * g.abs()
            p.grad = None
        jp, jopt, jm = jtrain(jp, jopt, jax.tree.map(jnp.asarray, b), lr)
        params, opt, m = train(params, opt, bt, lr)
        for k in ("loss", "moe_drop_rate", "moe_imbalance"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=STACK_TOL,
                                       atol=STACK_TOL, err_msg=k, equal_nan=True)
        metrics.append(m)
    want = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    n_off = n_all = 0
    for a, b, q0, u in zip(tree_leaves(params), tree_leaves(want), p0, unstable):
        a, b = a.detach(), b.detach()
        got, ref = a - q0, b - q0             # the updates themselves
        assert ref.abs().max() > 0.5 * lr     # the reference's weights moved
        off = (((a - b).abs() > STACK_TOL * (1 + b.abs()))
               | ((got - ref).abs() > 0.1 * lr))
        assert not (off & ~u).any(), int((off & ~u).sum())
        n_off, n_all = n_off + int(off.sum()), n_all + off.numel()
    assert n_off <= 1e-4 * n_all, (n_off, n_all)
    assert opt["step"] == len(batches)
    return metrics


@pytest.mark.parametrize("arch", STACK_ARCHS)
def test_three_train_steps_track_reference(arch):
    jcfg, cfg = _stack(arch)
    metrics = track_reference(
        jcfg, cfg, _jax_params(jcfg, 7), _packed(cfg, 3),
        jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="xla"),
        model.FwdCtx(attn_block=8))
    assert all(np.isfinite(m["moe_drop_rate"].item()) for m in metrics)


def test_params_from_jax_carries_the_expert_leaves():
    """Jamba's period 8 with MoE on odd layers: ``moe/{router (d, E),
    w_up and w_gate (E, d, ff), w_down (E, ff, d)}`` of layer b·8 + j come
    from ``blocks/pos{j}`` row b; the port's own init builds the same tree."""
    jcfg, cfg = _cfgs(n_layers=16, d_model=32, n_heads=4, n_kv_heads=2,
                      layer_pattern=("mamba", "mamba", "mamba", "mamba",
                                     "attention", "mamba", "mamba", "mamba"),
                      ffn_pattern=("dense", "moe"), family="hybrid")
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, 5))
    params = params_from_jax(jp, cfg, device="cpu")
    for i, fk in enumerate(cfg.ffn_kinds):
        b, j = divmod(i, 8)
        key = "moe" if fk == types.FFNKind.MOE else "ffn"
        assert key in params["layers"][i] and (i % 2 == 1) == (key == "moe")
        for name, leaf in params["layers"][i][key].items():
            np.testing.assert_array_equal(leaf.detach().numpy(),
                                          jp["blocks"][f"pos{j}"][key][name][b])
    m = params["layers"][3]["moe"]
    assert m["router"].shape == (32, 4)
    assert m["w_up"].shape == m["w_gate"].shape == (4, 32, 64)
    assert m["w_down"].shape == (4, 64, 32)
    got = model.init(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), got) == \
        jax.tree.map(lambda a: tuple(a.shape), params)


# --------------------------------------------------------------------------- #
# tests/test_moe_stats.py, ported: the same cases on both packages
# --------------------------------------------------------------------------- #
def test_capacity_stats_drop_and_imbalance():
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(1), jcfg))
    p = {k: _t(v) for k, v in jp.items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 32)))
    stats = {}
    for cf in (0.25, 8.0):
        _, _, st = moe.apply_capacity(p, _t(x), cfg, capacity_factor=cf,
                                      with_stats=True)
        _, _, jst = jmoe.apply_capacity(jp, x, jcfg, capacity_factor=cf,
                                        with_stats=True)
        for k in st:
            assert st[k].item() == pytest.approx(float(jst[k]), abs=1e-7)
        stats[cf] = st
    # tight capacity must drop assignments; generous capacity must not
    assert 0.0 < stats[0.25]["drop_rate"].item() <= 1.0
    assert stats[8.0]["drop_rate"].item() == 0.0
    for st in stats.values():
        imb = st["imbalance"].item()
        assert np.isfinite(imb) and imb >= 0.0
    # stats must not change the output or lb_loss contract
    y, lb = moe.apply_capacity(p, _t(x), cfg, capacity_factor=8.0)
    y2, lb2, _ = moe.apply_capacity(p, _t(x), cfg, capacity_factor=8.0,
                                    with_stats=True)
    assert torch.equal(y, y2) and lb.item() == lb2.item()


def test_dense_and_chunked_stats():
    jcfg, cfg = _cfgs()
    jp = jax.tree.map(np.asarray, jmoe.init(jax.random.PRNGKey(2), jcfg))
    p = {k: _t(v) for k, v in jp.items()}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (2, 16, 32)))
    _, _, st = moe.apply_dense(p, _t(x), cfg, with_stats=True)
    assert st["drop_rate"].item() == 0.0          # dense never drops
    assert np.isfinite(st["imbalance"].item())
    _, _, stc = moe.apply_capacity_chunked(p, _t(x), cfg, capacity_factor=0.5,
                                           chunk_tokens=8, with_stats=True)
    _, _, jstc = jmoe.apply_capacity_chunked(jp, x, jcfg, capacity_factor=0.5,
                                             chunk_tokens=8, with_stats=True)
    assert 0.0 <= stc["drop_rate"].item() <= 1.0
    assert np.isfinite(stc["imbalance"].item())
    for k in stc:
        assert stc[k].item() == pytest.approx(float(jstc[k]), abs=1e-7)


@pytest.mark.parametrize("has_moe", [True, False])
def test_train_step_metrics_keys(has_moe):
    over = {} if has_moe else dict(ffn_pattern=("dense",), n_experts=0, top_k=0,
                                   family="dense")
    jcfg, cfg = _cfgs(**over)
    jp = _jax_params(jcfg, 0)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (1, 2, 16), 1, 64))
    batch = {"tokens": toks, "labels": toks}
    jtrain = jax.jit(jstep.make_train_step(jcfg, joptim.AdamWConfig(), ctx=jmodel.FwdCtx(
        mode="train", attn_impl="naive", capacity_factor=0.5)))
    _, _, jm = jtrain(jp, joptim.adamw_init(jp), batch, 1e-3)
    train = step.make_train_step(cfg, optim.AdamWConfig(),
                                 ctx=model.FwdCtx(capacity_factor=0.5))
    _, _, m = train(params, optim.adamw_init(params),
                    step.as_tensors(batch, device="cpu"), 1e-3)
    assert set(m) >= {"loss", "moe_drop_rate", "moe_imbalance"}
    assert np.isfinite(m["loss"].item())
    if has_moe:
        assert 0.0 <= m["moe_drop_rate"].item() <= 1.0
        assert np.isfinite(m["moe_imbalance"].item())
        for k in ("moe_drop_rate", "moe_imbalance"):
            assert m[k].item() == pytest.approx(float(jm[k]), abs=1e-6)
    else:
        for k in ("moe_drop_rate", "moe_imbalance"):
            assert np.isnan(m[k].item()) and np.isnan(float(jm[k]))


def test_runtime_metrics_record_moe_nan_to_none():
    snaps = []
    for m in (RuntimeMetrics(window=8), JRuntimeMetrics(window=8)):
        snap = m.snapshot()
        assert snap["moe_drop_rate_mean"] is None        # empty window -> null
        assert snap["moe_imbalance_max"] is None
        m.record_moe(float("nan"), float("nan"))         # NaN observations skipped
        snap = m.snapshot()
        assert snap["moe_drop_rate_mean"] is None
        assert snap["moe_imbalance_max"] is None
        m.record_moe(0.1, 0.5)
        m.record_moe(0.3, 1.5)
        m.record_moe(float("nan"), 0.25)                 # per-field skip
        snap = m.snapshot()
        assert snap["moe_drop_rate_mean"] == pytest.approx(0.2)
        assert snap["moe_drop_rate_last"] == pytest.approx(0.3)
        assert snap["moe_imbalance_max"] == pytest.approx(1.5)
        assert snap["moe_imbalance_mean"] == pytest.approx(0.75)
        snaps.append({k: v for k, v in snap.items() if k.startswith("moe_")})
    assert snaps[0] == snaps[1]
