"""Port's layers and model stack against the reference, fp32 on the CPU.

Same numpy inputs and weights (``params_from_jax``) go through both
packages.  Tolerance: atol = rtol = 1e-5 for elementwise layers, 1e-4 for
stacks of matmuls.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.models import model as jmodel
from repro.models.layers import attention as jattn
from repro.models.layers import embed as jembed
from repro.models.layers import ffn as jffn
from repro.models.layers import norms as jnorms
from repro.models.layers import rope as jrope
from repro_torch.common import types
from repro_torch.convert import params_from_jax
from repro_torch.models import model
from repro_torch.models.layers import attention, embed, ffn, norms, rope

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

TOL = 1e-5
STACK_TOL = 1e-4


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _cfgs(**kw):
    """The same ModelConfig in both packages."""
    base = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=96, dtype="float32")
    base.update(kw)
    return jtypes.ModelConfig(**base), types.ModelConfig(**base)


def test_norms():
    x = _np(0, 2, 5, 16)
    scale, bias = _np(1, 16), _np(2, 16)
    np.testing.assert_allclose(
        norms.rms_apply({"scale": _t(scale)}, _t(x), 1e-5).numpy(),
        np.asarray(jnorms.rms_apply({"scale": scale}, x, 1e-5)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        norms.ln_apply({"scale": _t(scale), "bias": _t(bias)}, _t(x)).numpy(),
        np.asarray(jnorms.ln_apply({"scale": scale, "bias": bias}, x)),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    x = _np(3, 2, 7, 3, 16)
    pos = np.arange(7)[None].repeat(2, 0) + np.array([[0], [5]])
    np.testing.assert_allclose(
        rope.apply_rope(_t(x), _t(pos), theta).numpy(),
        np.asarray(jrope.apply_rope(x, pos, theta)), rtol=TOL, atol=TOL)


def test_embed():
    w, u = _np(4, 50, 8), _np(5, 8, 50)
    toks = np.random.default_rng(6).integers(0, 50, (2, 9)).astype(np.int32)
    h = _np(7, 2, 9, 8)
    np.testing.assert_array_equal(
        embed.encode({"w": _t(w)}, _t(toks)).numpy(),
        np.asarray(jembed.encode({"w": w}, toks)))
    np.testing.assert_allclose(embed.unembed({"w": _t(u)}, _t(h)).numpy(),
                               np.asarray(jembed.unembed({"w": u}, h)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(embed.decode({"w": _t(w)}, _t(h)).numpy(),
                               np.asarray(jembed.decode({"w": w}, h)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "geglu", "relu_sq"])
def test_ffn(activation):
    jcfg, cfg = _cfgs(activation=activation)
    p = jax.tree.map(np.asarray, jffn.init(jax.random.PRNGKey(0), jcfg))
    x = _np(8, 2, 5, 64)
    np.testing.assert_allclose(
        ffn.apply({k: _t(v) for k, v in p.items()}, _t(x), cfg).numpy(),
        np.asarray(jffn.apply(p, x, jcfg)), rtol=STACK_TOL, atol=STACK_TOL)


@pytest.mark.parametrize("impl,causal,window", [
    ("naive", True, 0), ("kernel", True, 0), ("kernel", False, 0),
    ("kernel", True, 8), ("naive", True, 8)])
def test_attention_apply(impl, causal, window):
    kw = dict(causal=causal, use_rope=causal)
    if window:
        kw.update(attention_kind="sliding", window_size=window)
    jcfg, cfg = _cfgs(**kw)
    p = jax.tree.map(np.asarray, jattn.init(jax.random.PRNGKey(1), jcfg))
    x = _np(9, 2, 21, 64)
    seg = np.r_[np.ones(12), np.zeros(9)].astype(np.int32)[None].repeat(2, 0)
    want, _ = jattn.apply(p, x, jcfg, segment_ids=jnp.asarray(seg), impl="naive")
    got = attention.apply({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                          segment_ids=_t(seg), impl=impl, block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STACK_TOL, atol=STACK_TOL)


def test_attend_naive_matches_reference():
    q, k, v = _np(10, 2, 13, 4, 8), _np(11, 2, 13, 2, 8), _np(12, 2, 13, 2, 8)
    seg = np.r_[np.full(6, 3), np.full(7, 1)].astype(np.int32)[None].repeat(2, 0)
    seg_q = seg.copy()
    seg_q[:, :2] = 9                       # rows that attend nothing
    want = jattn.attend_naive(q, k, v, causal=True, window=5,
                              seg_q=seg_q, seg_k=seg)
    got = attention.attend_naive(_t(q), _t(k), _t(v), causal=True, window=5,
                                 seg_q=_t(seg_q), seg_k=_t(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    assert np.all(got.numpy()[:, :2] == 0)


@pytest.mark.parametrize("kind", ["decoder", "encoder"])
def test_model_forward(kind):
    if kind == "decoder":
        jcfg, cfg = _cfgs(rope_theta=1e6)
        jp = jmodel.init(jax.random.PRNGKey(2), jcfg)
        toks = np.random.default_rng(13).integers(1, 96, (2, 24)).astype(np.int32)
        inputs = dict(tokens=toks)
    else:
        jcfg, cfg = _cfgs(vocab_size=0, causal=False, use_rope=False,
                          activation="gelu", input_embed_dim=48,
                          has_lm_head=False, n_kv_heads=4)
        jp = jmodel.init(jax.random.PRNGKey(3), jcfg)
        inputs = dict(embeds=_np(14, 2, 24, 48))
    seg = np.r_[np.ones(17), np.zeros(7)].astype(np.int32)[None].repeat(2, 0)
    want, _, jaux = jmodel.forward(
        jp, jcfg, segment_ids=jnp.asarray(seg),
        ctx=jmodel.FwdCtx(mode="train", attn_impl="naive"), **inputs)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    for block in (8, 512):
        got, _, aux = model.forward(
            params, cfg, segment_ids=_t(seg),
            ctx=model.FwdCtx(attn_impl="kernel", attn_block=block),
            **{k: _t(v) for k, v in inputs.items()})
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=STACK_TOL, atol=STACK_TOL)
    assert np.isnan(aux["moe_drop_rate"].item()) and np.isnan(
        np.asarray(jaux["moe_drop_rate"]))
    assert aux["lb_loss"].item() == 0.0


def test_unported_layers_raise():
    """MoE layers, once refused here, now build the reference's tree (a
    hybrid with MoE on every other layer); what still raises is an
    attention implementation the port does not have."""
    jcfg, cfg = _cfgs(layer_pattern=("attention", "mamba"), ffn_pattern=("dense", "moe"),
                      n_experts=4, top_k=2)
    got = model.init(cfg, device="cpu")
    want = jmodel.init(jax.random.PRNGKey(0), jcfg)
    assert [sorted(lp) for lp in got["layers"]] == [
        ["attn", "ffn", "ln1", "ln2"], ["ln1", "ln2", "mamba", "moe"]]
    assert jax.tree.map(lambda a: tuple(a.shape), got) == jax.tree.map(
        lambda a: tuple(a.shape), params_from_jax(jax.tree.map(np.asarray, want), cfg,
                                                  device="cpu"))
    with pytest.raises(ValueError, match="attention impl"):
        model.forward(got, cfg, tokens=torch.zeros((1, 8), dtype=torch.int32),
                      ctx=model.FwdCtx(attn_impl="pallas"))


def test_params_from_jax_keeps_layouts():
    jcfg, cfg = _cfgs(n_layers=3)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4), jcfg))
    params = params_from_jax(jp, cfg, device="cpu")
    assert len(params["layers"]) == 3
    for i in range(3):
        np.testing.assert_array_equal(
            params["layers"][i]["attn"]["wq"].detach().numpy(),
            jp["blocks"]["pos0"]["attn"]["wq"][i])
    assert params["unembed"]["w"].shape == (64, 96)
    assert params["layers"][0]["attn"]["wo"].shape == (4, 16, 64)
    assert all(p.requires_grad for p in params["layers"][0]["ffn"].values())


def test_configs_match_reference():
    from repro.configs import internvl2_2b as jcfgs
    from repro_torch.configs import internvl2_2b as cfgs
    for a, b in ((cfgs.ENCODER, jcfgs.ENCODER), (cfgs.LLM, jcfgs.LLM)):
        for f in dataclasses.fields(a):
            if f.name in types.PORT_ONLY_FIELDS:
                assert not getattr(a, f.name), f.name
            else:
                assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert cfgs.CFG.connector_hidden == jcfgs.CFG.connector_hidden
    assert cfgs.CFG.tokens_per_item_out == jcfgs.CFG.tokens_per_item_out
    assert cfgs.CFG.stub == type(cfgs.CFG.stub)(*dataclasses.astuple(jcfgs.CFG.stub))


def test_rms_norm_grad_at_zero_rows_matches_reference():
    """RMSNorm's Jacobian at an all-zero row is scale / sqrt(eps) (~316 at
    eps = 1e-5) in both packages.  Zero-padded media rows pass through the
    encoder unchanged, so at full depth (48 norms) their gradient overflows
    and the encoder's weight gradients turn non-finite — a reference fault
    the port reproduces (ROADMAP Queue 3)."""
    x = np.zeros((1, 2, 8), np.float32)
    x[0, 1] = _np(15, 8)
    scale, cot = _np(16, 8), _np(17, 1, 2, 8)
    _, vjp = jax.vjp(lambda x: jnorms.rms_apply({"scale": scale}, x, 1e-5), x)
    want = np.asarray(vjp(cot)[0])
    xt = torch.tensor(x, requires_grad=True)
    norms.rms_apply({"scale": _t(scale)}, xt, 1e-5).backward(_t(cot))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(want[0, 0], cot[0, 0] * scale / np.sqrt(1e-5),
                               rtol=1e-4)
