"""The slice end to end against the reference, fp32 on the CPU: the tiny
MLLM of ``examples/train_mllm.py::tiny_configs`` (rebuilt here), batches
from ``MixedDataset``, weights through ``params_from_jax``.

The reference runs ``attn_impl="naive"`` (its suite pins ``pallas`` equal
to it); the port runs ``attn_impl="kernel"`` (the kernels' plain versions on
the CPU).  Tolerances: forward logits and loss 1e-4; after 3 AdamW steps
at lr 1e-4, losses and parameters 1e-4.  (Adam moves every weight by about
lr whatever its gradient's size, so on a near-zero gradient the fp32
rounding of the two packages can show up at the scale of lr.)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.common import types as jtypes
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.models import mllm as jmllm
from repro.models.model import FwdCtx as JFwdCtx
from repro.train import optim as joptim
from repro.train import step as jstep
from repro.train.loss import cross_entropy as jce
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import mllm
from repro_torch.models.model import FwdCtx
from repro_torch.train import optim, step

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

TOL = 1e-4
N_MB, ROWS = 2, 2
MAX_MEDIA, MAX_TEXT = 32, 40


def _tiny(t):
    enc = t.ModelConfig(name="enc-tiny", family="vlm-enc", n_layers=2,
                        d_model=96, n_heads=4, n_kv_heads=4, d_ff=384,
                        vocab_size=0, causal=False, use_rope=False,
                        activation="gelu", input_embed_dim=64,
                        has_lm_head=False, dtype="float32")
    llm = t.ModelConfig(name="llm-tiny", family="dense", n_layers=2,
                        d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                        vocab_size=1024, dtype="float32")
    return t.MLLMConfig(name="mllm-tiny", encoder=enc, llm=llm,
                        stub=t.ModalityStub("vision", 16, 64),
                        connector_hidden=128, tokens_per_item_out=4)


JCFG, CFG = _tiny(jtypes), _tiny(types)


def _batches(n_steps, ds_cls=MixedDataset):
    ds = ds_cls("mixed", seed=0, tokens_per_media_item=8)
    out = []
    for s in range(n_steps):
        mbs = [ds.materialize(ds.sample(ROWS), embed_dim=64, vocab_size=1024,
                              max_media=MAX_MEDIA, max_text=MAX_TEXT,
                              seed=100 * s + i) for i in range(N_MB)]
        out.append({k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]})
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed):
    return jax.jit(jmllm.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _params():
    jp = _jax_params(JCFG, 0)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def test_synthetic_data_matches_reference():
    for a, b in zip(_batches(2), _batches(2, JMixedDataset)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_forward_train_and_loss():
    jp, params = _params()
    batch = _batches(1)[0]
    mb_np = {k: v[0] for k, v in batch.items()}
    want = jax.jit(lambda p, mb: jmllm.forward_train(
        p, JCFG, mb, ctx=JFwdCtx(mode="train", attn_impl="naive"))[0])(
            jp, jax.tree.map(jnp.asarray, mb_np))
    mb = {k: v[0] for k, v in step.as_tensors(batch, device="cpu").items()}
    got, aux = mllm.forward_train(params, CFG, mb, ctx=FwdCtx(attn_impl="kernel"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    jloss = jce(want, mb_np["labels"])      # the reference loss_fn's CE
    loss = step.make_loss_fn(CFG, FwdCtx(attn_impl="kernel"))(params, mb)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    assert np.isnan(aux["moe_imbalance"].item())


def test_three_train_steps_track_reference():
    jp, params = _params()
    batches = _batches(3)
    lr = 1e-4
    opt_cfg = joptim.AdamWConfig(lr=lr)
    jtrain = jax.jit(jstep.make_train_step(
        JCFG, opt_cfg, ctx=JFwdCtx(mode="train", attn_impl="naive")))
    train = step.make_train_step(CFG, optim.AdamWConfig(lr=lr),
                                 ctx=FwdCtx(attn_impl="kernel"))
    jopt, opt = joptim.adamw_init(jp), optim.adamw_init(params)
    for b in batches:
        jp, jopt, jm = jtrain(jp, jopt, jax.tree.map(jnp.asarray, b), lr)
        params, opt, m = train(params, opt, step.as_tensors(b, device="cpu"), lr)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=TOL, atol=TOL)
        assert np.isnan(m["moe_drop_rate"].item())
        assert np.isnan(m["moe_imbalance"].item())
    want = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL)
    assert opt["step"] == 3


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(5)
    p_np = {"w": rng.standard_normal((6, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}
    g_np = [{k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
             for k, v in p_np.items()} for _ in range(2)]
    cfg = joptim.AdamWConfig()
    jp, js = p_np, joptim.adamw_init(p_np)
    p = {k: torch.tensor(v) for k, v in p_np.items()}
    s = optim.adamw_init(p)
    for g in g_np:
        jp, js = joptim.adamw_update(cfg, jp, g, js, lr=1e-2)
        p, s = optim.adamw_update(optim.AdamWConfig(), p,
                                  {k: torch.tensor(v) for k, v in g.items()},
                                  s, lr=1e-2)
    for k in p:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(s["m"][k].numpy(), np.asarray(js["m"][k]),
                                   rtol=1e-6, atol=1e-6)



def test_adamw_decays_what_the_reference_decays():
    """The reference stacks each layer's leaves along a leading axis, so a
    layer's norm scale is 2-D there and decays; a 1-D leaf outside the
    layers (a final norm's scale) does not.  The port keeps one dict per
    layer and decays the same leaves."""
    rng = np.random.default_rng(6)
    n, d = 2, 4

    def tree():
        return {"blocks": {"pos0": {"scale": rng.standard_normal((n, d)).astype(np.float32)}},
                "final": rng.standard_normal((d,)).astype(np.float32)}

    def port(t):
        return {"layers": [{"scale": torch.tensor(t["blocks"]["pos0"]["scale"][i])}
                           for i in range(n)],
                "final": torch.tensor(t["final"])}

    jp, jg = tree(), tree()
    want, _ = joptim.adamw_update(joptim.AdamWConfig(), jp, jg, joptim.adamw_init(jp),
                                  lr=1e-2)
    p = port(jp)
    got, _ = optim.adamw_update(optim.AdamWConfig(), p, port(jg), optim.adamw_init(p),
                                lr=1e-2)
    for i in range(n):
        np.testing.assert_allclose(got["layers"][i]["scale"].numpy(),
                                   np.asarray(want["blocks"]["pos0"]["scale"][i]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["final"].numpy(), np.asarray(want["final"]),
                               rtol=1e-6, atol=1e-6)


def test_cosine_lr_matches_reference():
    j, t = joptim.cosine_lr(3e-4, 10, 100), optim.cosine_lr(3e-4, 10, 100)
    for s in (0, 1, 9, 10, 11, 55, 100, 140):
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6)


def test_cross_entropy_matches_reference():
    from repro_torch.train.loss import cross_entropy
    logits = np.random.default_rng(6).standard_normal((2, 5, 11)).astype(np.float32)
    labels = np.array([[1, 2, -1, 10, 0], [-1, -1, 3, 4, 5]], np.int32)
    np.testing.assert_allclose(
        cross_entropy(torch.tensor(logits), torch.tensor(labels)).item(),
        float(jce(logits, labels)), rtol=1e-6)


def test_padded_media_encoder_grads_match_reference():
    """Zero-padded media rows stay exactly zero through the encoder, where
    RMSNorm's Jacobian is scale / sqrt(eps) ≈ 316; over 16 norms (8 layers)
    their gradient overflows and the encoder's weight gradients turn
    non-finite — in the reference and, matching it, in the port (a
    reference fault, ROADMAP Queue 3).  Without padding both are finite
    and agree."""
    import dataclasses
    enc = lambda c: dataclasses.replace(c, encoder=dataclasses.replace(  # noqa: E731
        c.encoder, n_layers=8))
    jcfg, cfg = enc(JCFG), enc(CFG)
    jp = _jax_params(jcfg, 1)
    jgrad_fn = jax.jit(jax.grad(jstep.make_loss_fn(
        jcfg, JFwdCtx(mode="train", attn_impl="naive"))))
    rng = np.random.default_rng(0)
    for padded in (False, True):
        params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        n_real = 16 if padded else 32
        mb = {"media_embeds": np.zeros((1, 32, 64), np.float32),
              "media_mask": np.zeros((1, 32), np.int32),
              "text_tokens": rng.integers(1, 1024, (1, 16)).astype(np.int32),
              "text_mask": np.ones((1, 16), np.int32)}
        mb["media_embeds"][0, :n_real] = rng.standard_normal((n_real, 64)) * 0.02
        mb["media_mask"][0, :n_real] = 1
        mb["labels"] = mb["text_tokens"]
        want = np.asarray(
            jgrad_fn(jp, jax.tree.map(jnp.asarray, mb))["encoder"]["in_proj"]["w"])
        step.make_loss_fn(cfg, FwdCtx(attn_impl="kernel"))(
            params, step.as_tensors(mb, device="cpu")).backward()
        got = params["encoder"]["in_proj"]["w"].grad.numpy()
        assert np.isfinite(got).all() == np.isfinite(want).all() == (not padded)
        if not padded:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
