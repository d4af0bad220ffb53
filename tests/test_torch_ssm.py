"""The SSM slice against the reference, fp32 on the CPU: RWKV6 and Mamba
layers, the plain-decoder stack on a tiny RWKV6 model and a tiny period-8
hybrid (Jamba's pattern, dense FFNs), packing, the parameter conversion and
three train steps.

Same numpy inputs and weights (``params_from_jax``) go through both
packages; the reference runs its XLA scans and naive attention, the port
its kernel path (the kernels' plain versions on the CPU) and its naive
path.  Tolerances, atol = rtol: 1e-5 for elementwise layers, 1e-4 for
stacks of matmuls and recurrences, the forward of the model stacks and
three AdamW steps at lr 1e-4 (see ``test_torch_train.py`` on Adam).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.data import packing as jpacking
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.models import model as jmodel
from repro.models.layers import mamba as jmamba
from repro.models.layers import norms as jnorms
from repro.models.layers import rwkv6 as jrwkv6
from repro.train import optim as joptim
from repro.train import step as jstep
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.data import packing
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import model
from repro_torch.models.layers import mamba, norms, rwkv6
from repro_torch.train import optim, step

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

TOL = 1e-5
STACK_TOL = 1e-4
JAMBA_PATTERN = ("mamba", "mamba", "mamba", "mamba",
                 "attention", "mamba", "mamba", "mamba")
S, VOCAB = 24, 96


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def _t(x):
    return torch.tensor(np.array(x))


def _tree(p):
    return jax.tree.map(lambda a: _t(np.asarray(a)), p)


def _cfgs(kind, **kw):
    """The same tiny ModelConfig in both packages."""
    base = dict(name=f"{kind}-tiny", n_layers=2, d_ff=128, vocab_size=VOCAB,
                dtype="float32", use_rope=False)
    if kind == "rwkv6":
        base.update(family="ssm", d_model=64, n_heads=0, n_kv_heads=0,
                    layer_pattern=("rwkv6",), rwkv_head_dim=16)
    else:
        base.update(family="hybrid", d_model=32, n_heads=4, n_kv_heads=2,
                    n_layers=8, layer_pattern=JAMBA_PATTERN, d_ff=64)
    base.update(kw)
    return jtypes.ModelConfig(**base), types.ModelConfig(**base)


# --------------------------------------------------------------------------- #
# Layers
# --------------------------------------------------------------------------- #
def test_group_norm_heads():
    x = _np(0, 2, 5, 32, scale=3.0) + 1.0
    np.testing.assert_allclose(norms.group_norm_heads(_t(x), 4).numpy(),
                               np.asarray(jnorms.group_norm_heads(x, 4)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_rwkv6_time_mix(impl):
    jcfg, cfg = _cfgs("rwkv6")
    p = jax.tree.map(np.asarray, jrwkv6.init(jax.random.PRNGKey(0), jcfg))
    x = _np(1, 2, 19, 64)
    want, _ = jrwkv6.time_mix(p, x, jcfg, impl="xla")
    got = rwkv6.time_mix(_tree(p), _t(x), cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STACK_TOL, atol=STACK_TOL)


def test_rwkv6_channel_mix_and_shift():
    jcfg, cfg = _cfgs("rwkv6")
    p = jax.tree.map(np.asarray, jrwkv6.init(jax.random.PRNGKey(1), jcfg))
    x = _np(2, 2, 7, 64)
    want, _ = jrwkv6.channel_mix(p, x, jcfg)
    np.testing.assert_allclose(rwkv6.channel_mix(_tree(p), _t(x), cfg).numpy(),
                               np.asarray(want), rtol=STACK_TOL, atol=STACK_TOL)
    prev = _np(3, 2, 64)
    np.testing.assert_array_equal(rwkv6._shift(_t(x), _t(prev)).numpy(),
                                  np.asarray(jrwkv6._shift(x, prev)))
    np.testing.assert_allclose(
        rwkv6._ddlerp(_tree(p), _t(x), _t(x[:, ::-1])).numpy(),
        np.asarray(jrwkv6._ddlerp(p, x, x[:, ::-1])), rtol=TOL, atol=TOL)


def test_causal_conv():
    x, w, b = _np(4, 2, 11, 6), _np(5, 6, 4), _np(6, 6)
    np.testing.assert_allclose(mamba.causal_conv(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(jmamba.causal_conv(x, w, b)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["kernel", "naive"])
def test_mamba_apply(impl):
    jcfg, cfg = _cfgs("hybrid")
    p = jax.tree.map(np.asarray, jmamba.init(jax.random.PRNGKey(2), jcfg))
    x = _np(7, 2, 21, 32)
    want, _ = jmamba.apply(p, x, jcfg, impl="xla")
    got = mamba.apply(_tree(p), _t(x), cfg, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=STACK_TOL, atol=STACK_TOL)


def test_ssm_scan_naive_matches_reference():
    u, dt = _np(8, 2, 9, 12), np.abs(_np(9, 2, 9, 12)) * 0.3
    B_t, C_t = _np(10, 2, 9, 16), _np(11, 2, 9, 16)
    A, D = -np.exp(_np(12, 12, 16) * 0.3), _np(13, 12)
    y, h = mamba.ssm_scan_xla(*(_t(a) for a in (u, dt, B_t, C_t, A, D)))
    jy, jh = jmamba.ssm_scan_xla(u, dt, B_t, C_t, A, D)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=STACK_TOL, atol=STACK_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=STACK_TOL, atol=STACK_TOL)


# --------------------------------------------------------------------------- #
# Model stacks
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed):
    return jax.jit(jmodel.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _segments():
    """Two packed rows: segments 1..3 then a padding tail (segment 0)."""
    seg = np.zeros((2, S), np.int32)
    seg[0, :10], seg[0, 10:20] = 1, 2
    seg[1, :7], seg[1, 7:22] = 1, 3
    return seg


@pytest.mark.parametrize("kind", ["rwkv6", "hybrid"])
@pytest.mark.parametrize("ssm_impl", ["kernel", "naive"])
def test_model_forward(kind, ssm_impl):
    jcfg, cfg = _cfgs(kind)
    jp = _jax_params(jcfg, 3)
    toks = np.random.default_rng(14).integers(1, VOCAB, (2, S)).astype(np.int32)
    seg = _segments()
    want, _, _ = jax.jit(lambda p: jmodel.forward(
        p, jcfg, tokens=toks, segment_ids=jnp.asarray(seg),
        ctx=jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="xla")))(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    got, _, aux = model.forward(params, cfg, tokens=_t(toks), segment_ids=_t(seg),
                                ctx=model.FwdCtx(ssm_impl=ssm_impl, attn_block=8))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=STACK_TOL, atol=STACK_TOL)
    assert np.isnan(aux["moe_drop_rate"].item())


def test_params_from_jax_unstacks_ssm_trees():
    """Period 8 (Jamba's), two blocks: layer i = block * 8 + j comes from
    ``blocks/pos{j}`` row ``block``, with Mamba, attention and RWKV6 leaves
    in their reference layouts."""
    jcfg, cfg = _cfgs("hybrid", n_layers=16)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(5), jcfg))
    params = params_from_jax(jp, cfg, device="cpu")
    assert len(params["layers"]) == 16
    for i, kind in enumerate(cfg.layer_kinds):
        b, j = divmod(i, 8)
        lp, jl = params["layers"][i], jp["blocks"][f"pos{j}"]
        key = "attn" if kind == types.LayerKind.ATTENTION else "mamba"
        assert set(lp) == {"ln1", key, "ln2", "ffn"}
        for name, leaf in lp[key].items():
            np.testing.assert_array_equal(leaf.detach().numpy(), jl[key][name][b])
    assert params["layers"][13]["mamba"]["x_proj"].shape == (64, 2 + 2 * 16)
    assert params["layers"][12]["attn"]["wq"].shape == (32, 4, 8)
    jcfg, cfg = _cfgs("rwkv6", n_layers=3)
    jp = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(6), jcfg))
    params = params_from_jax(jp, cfg, device="cpu")
    assert set(params["layers"][2]) == {"ln1", "rwkv", "ln2"}
    for name, leaf in params["layers"][2]["rwkv"].items():
        np.testing.assert_array_equal(leaf.detach().numpy(),
                                      jp["blocks"]["pos0"]["rwkv"][name][2])
    assert params["layers"][0]["rwkv"]["lora_a"].shape == (64, 5, 32)
    assert all(p.requires_grad for p in tree_leaves(params))


def test_port_init_matches_reference_tree():
    """The port's random init builds the reference's tree: same paths, same
    shapes."""
    for kind in ("rwkv6", "hybrid"):
        jcfg, cfg = _cfgs(kind)
        want = params_from_jax(jax.tree.map(np.asarray, _jax_params(jcfg, 3)),
                               cfg, device="cpu")
        got = model.init(cfg, seed=0, device="cpu")
        assert jax.tree.map(lambda a: tuple(a.shape), got) == \
            jax.tree.map(lambda a: tuple(a.shape), want)


def test_configs_match_reference():
    from repro.configs import jamba_v0_1_52b as jjamba
    from repro.configs import rwkv6_7b as jrwkv
    from repro_torch.configs import jamba_v0_1_52b, rwkv6_7b
    for a, b in ((rwkv6_7b.CFG, jrwkv.CFG), (jamba_v0_1_52b.CFG, jjamba.CFG)):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name


# --------------------------------------------------------------------------- #
# Packing and the train step
# --------------------------------------------------------------------------- #
N_MB, ROWS, TPM = 2, 2, 4


def _packed(n_steps, ds_cls=MixedDataset, pack=packing.pack_items):
    """``n_steps`` batches of N_MB x ROWS packed rows of S tokens."""
    ds = ds_cls("mixed", seed=0, tokens_per_media_item=TPM)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n_steps):
        rows = [pack(ds.sample(3), S, TPM, VOCAB, rng) for _ in range(N_MB * ROWS)]
        out.append({k: np.stack([getattr(pb, k)[0] for pb in rows]).reshape(
            N_MB, ROWS, S) for k in ("tokens", "labels", "segment_ids", "positions")})
    return out


def test_pack_items_matches_reference():
    for a, b in zip(_packed(2), _packed(2, JMixedDataset, jpacking.pack_items)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    items = MixedDataset("mixed", seed=3, tokens_per_media_item=TPM).sample(5)
    pb = packing.pack_items(items, 64, TPM, VOCAB, np.random.default_rng(0))
    jpb = jpacking.pack_items(items, 64, TPM, VOCAB, np.random.default_rng(0))
    assert (pb.used, pb.truncated, pb.padding, pb.n_items) == \
        (jpb.used, jpb.truncated, jpb.padding, jpb.n_items)
    assert pb.used + pb.truncated == sum(it.llm_seq_len(TPM) for it in items)


@pytest.mark.parametrize("kind", ["rwkv6", "hybrid"])
def test_three_train_steps_track_reference(kind):
    jcfg, cfg = _cfgs(kind)
    jp = _jax_params(jcfg, 7)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    lr = 1e-4
    jtrain = jax.jit(jstep.make_train_step(
        jcfg, joptim.AdamWConfig(lr=lr),
        ctx=jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="xla")))
    train = step.make_train_step(cfg, optim.AdamWConfig(lr=lr),
                                 ctx=model.FwdCtx(attn_block=8))
    jopt, opt = joptim.adamw_init(jp), optim.adamw_init(params)
    p0 = [p.detach().clone() for p in tree_leaves(params)]
    for b in _packed(3):
        jp, jopt, jm = jtrain(jp, jopt, jax.tree.map(jnp.asarray, b), lr)
        params, opt, m = train(params, opt, step.as_tensors(b, device="cpu"), lr)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=STACK_TOL, atol=STACK_TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    for a, b, q0 in zip(tree_leaves(params), tree_leaves(want), p0):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=STACK_TOL, atol=STACK_TOL)
        # the update itself, within 0.1 lr (see test_torch_llava.py)
        got, ref = a.detach() - q0, b.detach() - q0
        assert ref.abs().max() > lr           # the reference's weights moved
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0.1 * lr)
    assert opt["step"] == 3


def test_encoder_only_loss_stays_unported():
    _, cfg = _cfgs("rwkv6", input_embed_dim=16)
    with pytest.raises(NotImplementedError, match="encoder-only"):
        step.make_loss_fn(cfg)
