"""The LLaVA-OneVision (SigLIP + Qwen2.5-7B) slice against the reference,
fp32 on the CPU.

The port's ``configs/llava_ov_qwen7b.py`` is held field by field against the
reference's.  A tiny LLaVA-shaped MLLM then goes through both packages with
the same weights (``params_from_jax``) and the same batches
(``MixedDataset``): its encoder runs attention at head dim 72 (SigLIP's,
d_model 144 over 2 heads), its LLM GQA with G = 7 (Qwen2.5-7B's 28 / 4), and
its media window of 5 images x 9 patches = 45 tokens does not divide by the
6 pooled tokens (factor 7, a 3-token tail dropped), as 5 x 729 = 3645 does not
by LLaVA-OV's 196 (factor 18, a 9-token tail).

The reference runs ``attn_impl="naive"``; the port ``attn_impl="kernel"``
(the kernels' plain versions on the CPU).  Tolerances are
``test_torch_train.py``'s (forward, loss, gradients, losses after 3 AdamW
steps: 1e-4), and the 3 steps at its lr 1e-4 hold each parameter's update
p3 - p0 to the reference's within 0.1 lr: Adam moves a weight by about lr a
step whatever its gradient's size, so a tolerance above lr would pass an
update that did nothing or went the wrong way.  Where the first gradient
is below GRAD_NOISE but not zero, its sign is fp32 rounding and may differ
between the packages (one element of a token's embedding row here), moving
the weight by 2 lr a step the other way: those elements alone are left out
of the update comparison, and they must stay a small share.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.common import types as jtypes
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
# Above the fp32 disagreement of the two packages' gradients (at most
# 3.7e-7 here, against a largest gradient of 0.16); below it a gradient's
# sign is rounding.
GRAD_NOISE = 1e-6
N_MB, ROWS = 2, 2
PATCHES, IMAGES = 9, 5
MAX_MEDIA, MAX_TEXT = PATCHES * IMAGES, 40
POOLED = 6                            # 45 // 6 = 7 tokens a pool, 3 dropped
EMBED = 48


def _tiny(t):
    enc = t.ModelConfig(name="siglip-tiny", family="vlm-enc", n_layers=2,
                        d_model=144, n_heads=2, n_kv_heads=2, d_ff=288,
                        vocab_size=0, causal=False, use_rope=False,
                        activation="gelu", input_embed_dim=EMBED,
                        has_lm_head=False, dtype="float32")
    llm = t.ModelConfig(name="qwen-tiny", family="dense", n_layers=2,
                        d_model=224, n_heads=7, n_kv_heads=1, d_ff=448,
                        vocab_size=1024, activation="swiglu",
                        rope_theta=1_000_000.0, dtype="float32")
    return t.MLLMConfig(name="llava-tiny", encoder=enc, llm=llm,
                        stub=t.ModalityStub("vision", PATCHES, EMBED),
                        connector_hidden=224, tokens_per_item_out=POOLED)


JCFG, CFG = _tiny(jtypes), _tiny(types)


def _batches(n_steps):
    """Rows of the paper's mix whose media fill the window (5 images or
    more, as the smoke's LLaVA-OV rows do), materialized by the port's
    MixedDataset (held equal to the reference's in test_torch_train.py)."""
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=PATCHES)

    def rows(n):
        items = []
        while len(items) < n:
            it = ds.sample(1)[0]
            if it.n_media_items * PATCHES >= MAX_MEDIA:
                items.append(it)
        return items

    out = []
    for s in range(n_steps):
        mbs = [ds.materialize(rows(ROWS), embed_dim=EMBED, vocab_size=1024,
                              max_media=MAX_MEDIA, max_text=MAX_TEXT,
                              seed=100 * s + i) for i in range(N_MB)]
        out.append({k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]})
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(seed):
    return jax.jit(jmllm.init, static_argnums=1)(jax.random.PRNGKey(seed), JCFG)


def _params():
    jp = _jax_params(0)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")


def test_config_matches_reference():
    from repro.configs import llava_ov_qwen7b as jcfgs
    from repro_torch.configs import llava_ov_qwen7b as cfgs
    for a, b in ((cfgs.ENCODER, jcfgs.ENCODER), (cfgs.LLM, jcfgs.LLM)):
        for f in dataclasses.fields(a):
            if f.name in types.PORT_ONLY_FIELDS:
                assert not getattr(a, f.name), f.name
            else:
                assert getattr(a, f.name) == getattr(b, f.name), f.name
    for f in dataclasses.fields(cfgs.CFG):
        if f.name not in ("encoder", "llm", "stub"):
            assert getattr(cfgs.CFG, f.name) == getattr(jcfgs.CFG, f.name), f.name
    assert cfgs.CFG.stub == type(cfgs.CFG.stub)(*dataclasses.astuple(jcfgs.CFG.stub))
    assert cfgs.CFG.encoder is cfgs.ENCODER and cfgs.CFG.llm is cfgs.LLM
    # the attention shapes the smoke trains: SigLIP at head dim 72, Qwen2.5
    # at 128 with 7 query heads per kv head
    assert cfgs.ENCODER.head_dim == 72 and cfgs.LLM.head_dim == 128
    assert cfgs.LLM.n_heads // cfgs.LLM.n_kv_heads == 7


def test_tiny_config_has_the_slice_shapes():
    assert CFG.encoder.head_dim == 72
    assert CFG.llm.n_heads // CFG.llm.n_kv_heads == 7
    factor = MAX_MEDIA // POOLED
    assert MAX_MEDIA // factor == POOLED and MAX_MEDIA % factor == 3


def test_encode_media_pool_drops_the_tail_as_the_reference():
    """The mean-pool over a window the pool does not divide: 45 tokens give
    factor 7, 6 pooled tokens, and the last 3 tokens are dropped — the same
    tokens, to 1e-4, as the reference's encode_media."""
    jp, params = _params()
    mb = _batches(1)[0]
    emb, mask = mb["media_embeds"][0], mb["media_mask"][0]
    want = jmllm.encode_media(jp, JCFG, jnp.asarray(emb), jnp.asarray(mask),
                              ctx=JFwdCtx(mode="train", attn_impl="naive"))
    got = mllm.encode_media(params, CFG, torch.tensor(emb), torch.tensor(mask),
                            ctx=FwdCtx(attn_impl="kernel"))
    assert got.shape == (ROWS, POOLED, CFG.llm.d_model) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    # the tail is dropped: pooled token i is the mean of tokens [7 i, 7 i + 7)
    h = mllm.apply_connector(params["connector"], torch.tensor(
        np.asarray(jmllm.model_lib.forward(
            jp["encoder"], JCFG.encoder, embeds=jnp.asarray(emb),
            segment_ids=jnp.asarray(mask, jnp.int32),
            ctx=JFwdCtx(mode="train", attn_impl="naive"))[0])), CFG)
    np.testing.assert_allclose(
        got.detach().numpy(),
        h[:, :POOLED * 7].reshape(ROWS, POOLED, 7, -1).mean(2).detach().numpy(),
        rtol=TOL, atol=TOL)


def test_forward_train_and_loss():
    jp, params = _params()
    batch = _batches(1)[0]
    mb_np = {k: v[0] for k, v in batch.items()}
    want = jax.jit(lambda p, mb: jmllm.forward_train(
        p, JCFG, mb, ctx=JFwdCtx(mode="train", attn_impl="naive"))[0])(
            jp, jax.tree.map(jnp.asarray, mb_np))
    mb = {k: v[0] for k, v in step.as_tensors(batch, device="cpu").items()}
    got, _ = mllm.forward_train(params, CFG, mb, ctx=FwdCtx(attn_impl="kernel"))
    assert got.shape == (ROWS, MAX_TEXT, CFG.llm.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    loss = step.make_loss_fn(CFG, FwdCtx(attn_impl="kernel"))(params, mb)
    np.testing.assert_allclose(loss.item(), float(jce(want, mb_np["labels"])),
                               rtol=TOL, atol=TOL)


def test_loss_gradients_match_reference():
    jp, params = _params()
    mb_np = {k: v[0] for k, v in _batches(1)[0].items()}
    want = jax.jit(jax.grad(jstep.make_loss_fn(
        JCFG, JFwdCtx(mode="train", attn_impl="naive"))))(
            jp, jax.tree.map(jnp.asarray, mb_np))
    loss = step.make_loss_fn(CFG, FwdCtx(attn_impl="kernel"))(
        params, step.as_tensors(mb_np, device="cpu"))
    loss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, want), CFG, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(want)):
        np.testing.assert_allclose(a.grad.numpy(), b.detach().numpy(),
                                   rtol=TOL, atol=TOL)


def test_three_train_steps_track_reference():
    jp, params = _params()
    p0 = [p.detach().clone() for p in tree_leaves(params)]
    lr = 1e-4
    jctx = JFwdCtx(mode="train", attn_impl="naive")
    batches = _batches(3)
    # the reference's first gradient, the mean over the step's microbatches
    jgrad = jax.jit(jax.grad(jstep.make_loss_fn(JCFG, jctx)))
    g1 = [jgrad(jp, jax.tree.map(lambda x, i=i: jnp.asarray(x[i]), batches[0]))
          for i in range(N_MB)]
    g1 = params_from_jax(jax.tree.map(lambda *g: sum(map(np.asarray, g)) / N_MB, *g1),
                         CFG, device="cpu")
    jtrain = jax.jit(jstep.make_train_step(JCFG, joptim.AdamWConfig(lr=lr), ctx=jctx))
    train = step.make_train_step(CFG, optim.AdamWConfig(lr=lr),
                                 ctx=FwdCtx(attn_impl="kernel"))
    jopt, opt = joptim.adamw_init(jp), optim.adamw_init(params)
    for b in batches:
        jp, jopt, jm = jtrain(jp, jopt, jax.tree.map(jnp.asarray, b), lr)
        params, opt, m = train(params, opt, step.as_tensors(b, device="cpu"), lr)
        assert np.isfinite(m["loss"].item())
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=TOL, atol=TOL)
    want = params_from_jax(jax.tree.map(np.asarray, jp), CFG, device="cpu")
    n_noise = n_all = 0
    for a, b, q0, g in zip(tree_leaves(params), tree_leaves(want), p0, tree_leaves(g1)):
        keep = ~((g != 0) & (g.abs() < GRAD_NOISE))
        n_noise += int((~keep).sum())
        n_all += keep.numel()
        got, ref = (a.detach() - q0)[keep], (b.detach() - q0)[keep]
        assert ref.abs().max() > lr           # the reference's weights moved
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=0.1 * lr)
    assert n_noise <= 1e-3 * n_all, (n_noise, n_all)
    assert opt["step"] == 3
