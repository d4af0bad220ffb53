"""The architecture registry against the reference, and every assigned
architecture's reduced configuration through both packages, fp32 on the
CPU.

Every registered ``ArchSpec`` is held field by field against the
reference's (its config, and for an MLLM its encoder, LLM and stub),
with ``reduced_desc()`` and ``supported_shapes()``.  Each ``ASSIGNED``
architecture's ``reduced_desc()`` then runs a forward and one AdamW step
in both packages from the same weights (``params_from_jax``) and inputs:
packed rows for a decoder, seeded frame embeddings with masked-prediction
labels for the encoder-only HuBERT, ``MixedDataset`` rows for the MLLM.
Tolerances are ``test_torch_moe.py``'s: 1e-4 for the forward, the loss
and the parameters, each update within 0.1 lr (``track_reference``); 1e-6
for the losses alone.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.configs import ASSIGNED as JASSIGNED
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.models import mllm as jmllm
from repro.models import model as jmodel
from repro.train import loss as jloss
from repro_torch.common import types
from repro_torch.configs import ASSIGNED, get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.data import packing
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import mllm, model
from repro_torch.train import loss
from test_torch_moe import track_reference

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

STACK_TOL = 1e-4
ARCHS = jlist_archs()
S = 80                                # above Mixtral's reduced window of 64


def _t(x):
    return torch.tensor(np.array(x))


def _same_config(a, b):
    """A port ModelConfig against the reference's, field by field; the
    reference's one other field is ``scan_layers`` (the port has no
    ``lax.scan``); the port's own fields are off in every registered
    config."""
    names = {f.name for f in dataclasses.fields(a)} - set(types.PORT_ONLY_FIELDS)
    assert {f.name for f in dataclasses.fields(b)} - names == {"scan_layers"}
    assert not any(getattr(a, n) for n in types.PORT_ONLY_FIELDS), a.name
    for n in names:
        assert getattr(a, n) == getattr(b, n), (a.name, n)
    for prop in ("layer_kinds", "ffn_kinds"):
        assert [k.value for k in getattr(a, prop)] == [k.value for k in getattr(b, prop)]
    for prop in ("block_period", "is_attention_free", "supports_long_context",
                 "is_decoder"):
        assert getattr(a, prop) == getattr(b, prop), prop
    assert (a.param_count(), a.active_param_count()) == \
        (b.param_count(), b.active_param_count())


def _same_desc(a, b):
    if isinstance(b, jtypes.MLLMConfig):
        assert isinstance(a, types.MLLMConfig)
        _same_config(a.encoder, b.encoder)
        _same_config(a.llm, b.llm)
        assert dataclasses.astuple(a.stub) == dataclasses.astuple(b.stub)
        for n in ("name", "connector_hidden", "tokens_per_item_out"):
            assert getattr(a, n) == getattr(b, n), n
        assert a.param_count() == b.param_count()
    else:
        assert isinstance(a, types.ModelConfig)
        _same_config(a, b)


def test_registry_lists_match_reference():
    assert list_archs() == ARCHS
    assert list_archs(assigned_only=True) == jlist_archs(assigned_only=True)
    assert ASSIGNED == JASSIGNED
    assert len(ARCHS) == 13 and set(ASSIGNED) <= set(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    spec, jspec = get_config(arch), jget_config(arch)
    for n in ("arch_id", "citation", "notes", "tokens_per_media_item", "is_mllm"):
        assert getattr(spec, n) == getattr(jspec, n), n
    _same_desc(spec.desc, jspec.desc)
    _same_config(spec.llm_cfg, jspec.llm_cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_and_shapes_match_reference(arch):
    spec, jspec = get_config(arch), jget_config(arch)
    _same_desc(spec.reduced_desc(), jspec.reduced_desc())
    assert spec.supported_shapes() == jspec.supported_shapes()
    assert {k: dataclasses.astuple(v) for k, v in types.INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jtypes.INPUT_SHAPES.items()}
    assert {k: v.tokens for k, v in types.INPUT_SHAPES.items()} == \
        {k: v.tokens for k, v in jtypes.INPUT_SHAPES.items()}
    # overrides go through as in the reference
    cfg = spec.llm_cfg
    _same_config(types.reduced(cfg, n_layers=4, dtype="bfloat16"),
                 jtypes.reduced(jspec.llm_cfg, n_layers=4, dtype="bfloat16"))


def test_frame_embed_dims():
    from repro.configs import hubert_xlarge as jhubert
    from repro.configs import qwen2_audio_7b as jqwen_audio
    from repro_torch.configs import hubert_xlarge, qwen2_audio_7b
    assert hubert_xlarge.FRAME_EMBED_DIM == jhubert.FRAME_EMBED_DIM == 512
    assert qwen2_audio_7b.FRAME_EMBED_DIM == jqwen_audio.FRAME_EMBED_DIM == 128
    assert hubert_xlarge.CFG.input_embed_dim == 512 and not hubert_xlarge.CFG.causal


# --------------------------------------------------------------------------- #
# Every assigned architecture, reduced: a forward and a train step
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _jax_params(desc, seed):
    init = jmllm.init if isinstance(desc, jtypes.MLLMConfig) else jmodel.init
    return jax.jit(init, static_argnums=1)(jax.random.PRNGKey(seed), desc)


def _decoder_batch(cfg, seed, n_mb=1, rows=2, tpm=4):
    """n_mb x rows packed rows of S tokens (``pack_items``)."""
    ds = MixedDataset("mixed", seed=seed, tokens_per_media_item=tpm)
    rng = np.random.default_rng(seed)
    packed = [packing.pack_items(ds.sample(6), S, tpm, cfg.vocab_size, rng)
              for _ in range(n_mb * rows)]
    return {k: np.stack([getattr(pb, k)[0] for pb in packed]).reshape(n_mb, rows, S)
            for k in ("tokens", "labels", "segment_ids", "positions")}


def _encoder_batch(cfg, seed, n_mb=1, rows=2):
    """HuBERT-style masked prediction: frame embeddings, a unit label on
    about half the frames (-1 elsewhere), a padded tail as segment 0."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n_mb, rows, S, cfg.input_embed_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (n_mb, rows, S)).astype(np.int32)
    labels[rng.random((n_mb, rows, S)) < 0.5] = -1
    seg = np.ones((n_mb, rows, S), np.int32)
    seg[:, 1, S - 16:] = 0
    labels[seg == 0] = -1
    return {"frame_embeds": emb, "labels": labels, "segment_ids": seg}


def _mllm_batch(desc, seed, n_mb=1, rows=2):
    ds = MixedDataset("mixed", seed=seed, tokens_per_media_item=desc.stub.n_tokens)
    mbs = [ds.materialize(ds.sample(rows), embed_dim=desc.stub.embed_dim,
                          vocab_size=desc.llm.vocab_size, max_media=2 * desc.stub.n_tokens,
                          max_text=40, seed=10 * seed + i) for i in range(n_mb)]
    return {k: np.stack([mb[k] for mb in mbs]) for k in mbs[0]}


def _batch(desc, seed, **kw):
    if isinstance(desc, types.MLLMConfig):
        return _mllm_batch(desc, seed, **kw)
    if desc.input_embed_dim > 0:
        return _encoder_batch(desc, seed, **kw)
    return _decoder_batch(desc, seed, **kw)


def _forward_pair(jdesc, desc, jp, mb):
    """The reference's and the port's forward outputs on one microbatch."""
    jctx = jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="xla")
    ctx = model.FwdCtx(attn_block=8)
    params = params_from_jax(jax.tree.map(np.asarray, jp), desc, device="cpu")
    mbt = {k: _t(v) for k, v in mb.items()}
    if isinstance(desc, types.MLLMConfig):
        want = jax.jit(lambda p: jmllm.forward_train(p, jdesc, mb, ctx=jctx)[0])(jp)
        got, _ = mllm.forward_train(params, desc, mbt, ctx=ctx)
        return want, got
    if desc.input_embed_dim > 0:
        inputs = dict(embeds=mb["frame_embeds"])
    else:
        inputs = dict(tokens=mb["tokens"], positions=mb["positions"])
    want = jax.jit(lambda p: jmodel.forward(
        p, jdesc, segment_ids=mb["segment_ids"], ctx=jctx, **inputs)[0])(jp)
    got, _, _ = model.forward(params, desc, segment_ids=mbt["segment_ids"], ctx=ctx,
                              **{k: _t(v) for k, v in inputs.items()})
    return want, got


@pytest.mark.parametrize("arch", ASSIGNED)
def test_reduced_forward_and_step_match_reference(arch):
    jdesc, desc = jget_config(arch).reduced_desc(), get_config(arch).reduced_desc()
    jp = _jax_params(jdesc, 0)
    batch = _batch(desc, 1)
    want, got = _forward_pair(jdesc, desc, jp, {k: v[0] for k, v in batch.items()})
    assert np.all(np.isfinite(np.asarray(want)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=STACK_TOL, atol=STACK_TOL)
    track_reference(jdesc, desc, jp, [batch],
                    jmodel.FwdCtx(mode="train", attn_impl="naive", ssm_impl="xla"),
                    model.FwdCtx(attn_block=8))


def test_encoder_only_loss_three_steps():
    """The reduced HuBERT-XLarge's masked-prediction loss over 3 AdamW
    steps of 2 microbatches."""
    jdesc, desc = (get.reduced_desc() for get in (jget_config("hubert-xlarge"),
                                                  get_config("hubert-xlarge")))
    metrics = track_reference(
        jdesc, desc, _jax_params(jdesc, 2), [_batch(desc, s, n_mb=2) for s in range(3)],
        jmodel.FwdCtx(mode="train", attn_impl="naive"), model.FwdCtx(attn_block=8))
    assert all(np.isnan(m["moe_drop_rate"].item()) for m in metrics)


def test_mllm_batches_match_reference():
    """The MLLM rows above are the reference's own."""
    desc = get_config("internvl2-2b").reduced_desc()
    ds, jds = (cls("mixed", seed=1, tokens_per_media_item=desc.stub.n_tokens)
               for cls in (MixedDataset, JMixedDataset))
    a = ds.materialize(ds.sample(2), embed_dim=64, vocab_size=512, max_media=32,
                       max_text=40, seed=3)
    b = jds.materialize(jds.sample(2), embed_dim=64, vocab_size=512, max_media=32,
                        max_text=40, seed=3)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------- #
# Losses
# --------------------------------------------------------------------------- #
def _logits_labels():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 9, 37)) * 3).astype(np.float32)
    logits[0, 0, [4, 11]] = 50.0          # a tie: argmax takes the first
    labels = rng.integers(0, 37, (2, 9)).astype(np.int32)
    labels[0, 0] = 4
    labels[1, 5:] = -1
    labels[:, 1] = np.argmax(logits[:, 1], -1)    # some correct predictions
    return logits, labels


@pytest.mark.parametrize("z", [0.0, 1e-4, 0.1])
def test_cross_entropy_z_loss_matches_reference(z):
    logits, labels = _logits_labels()
    lt = _t(logits).requires_grad_(True)
    got = loss.cross_entropy(lt, _t(labels), z_loss=z)
    want, jg = jax.value_and_grad(
        lambda x: jloss.cross_entropy(x, labels, z_loss=z))(logits)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    got.backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    mask = np.random.default_rng(1).random(labels.shape) < 0.5
    np.testing.assert_allclose(
        loss.masked_cross_entropy(_t(logits), _t(labels), _t(mask), z_loss=z).item(),
        float(jloss.masked_cross_entropy(logits, labels, mask, z_loss=z)),
        rtol=1e-6, atol=1e-6)
    if z:
        assert got.item() > loss.cross_entropy(_t(logits), _t(labels)).item()


def test_token_accuracy_matches_reference():
    logits, labels = _logits_labels()
    got = loss.token_accuracy(_t(logits), _t(labels)).item()
    assert got == pytest.approx(float(jloss.token_accuracy(logits, labels)), abs=1e-7)
    assert 0.0 < got < 1.0
    none = np.full_like(labels, -1)       # no label: 0, not a division by 0
    assert loss.token_accuracy(_t(logits), _t(none)).item() == \
        float(jloss.token_accuracy(logits, none)) == 0.0
