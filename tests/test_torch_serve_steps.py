"""The serving steps against the reference, fp32 on the CPU: decode caches
and ``decode_step`` (dense GQA, a sliding window whose ring wraps, a
Mamba + attention hybrid, RWKV6 and MoE), greedy generation, prefill, the
chunked scans, chunked prefill and the cache-row helpers.

Same numpy inputs and weights (``params_from_jax``) go through both
packages; each config's reference runs are made once per module.
Tolerances, atol = rtol: 1e-5 for decode logits and the caches' KV
entries and token shifts (one token through a few layers), 1e-4 for the
recurrent states (Mamba's ``ssm``, RWKV6's ``wkv``: sums over every step so
far), prefill logits and the chunked scans against the reference (a whole
sequence through the stack).  Tokens,
``kpos`` and the cache-row moves are held exactly.  Nothing here reads a
clock.
"""
import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import types as jtypes
from repro.models import model as jmodel
from repro.models.layers import attention as jattention
from repro.models.layers import mamba as jmamba
from repro.models.layers import rwkv6 as jrwkv6
from repro.serve import steps as jsteps
from repro_torch.common import types
from repro_torch.common.pytree import tree_leaves, tree_paths
from repro_torch.convert import caches_from_jax, params_from_jax
from repro_torch.models import model
from repro_torch.models.layers import attention, mamba, rwkv6
from repro_torch.models.model import FwdCtx
from repro_torch.serve import steps

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

TOL = 1e-5
SEQ_TOL = 1e-4
VOCAB = 64
B, PROMPT, MAX_NEW, MAX_LEN = 2, 6, 24, 32
WINDOW = 16                   # the sliding config's ring: 30 tokens wrap it
CFGS = {
    "dense": dict(family="dense", n_layers=2, d_model=32, n_heads=4,
                  n_kv_heads=2, d_ff=64),
    "sliding": dict(family="dense", n_layers=2, d_model=32, n_heads=4,
                    n_kv_heads=1, d_ff=64, attention_kind="sliding",
                    window_size=WINDOW),
    "hybrid": dict(family="hybrid", n_layers=4, d_model=32, n_heads=4,
                   n_kv_heads=2, d_ff=64, layer_pattern=("mamba", "attention")),
    "rwkv6": dict(family="ssm", n_layers=2, d_model=64, n_heads=0,
                  n_kv_heads=0, d_ff=128, layer_pattern=("rwkv6",),
                  rwkv_head_dim=16),
    "moe": dict(family="moe", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                d_ff=64, ffn_pattern=("moe",), n_experts=4, top_k=2),
}


def _cfgs(name, **kw):
    """The same tiny ModelConfig in both packages."""
    base = dict(name=f"{name}-tiny", vocab_size=VOCAB, dtype="float32",
                param_dtype="float32", **CFGS[name])
    base.update(kw)
    return jtypes.ModelConfig(**base), types.ModelConfig(**base)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prompt(seed, b=B, s=PROMPT):
    return np.random.default_rng(seed).integers(2, VOCAB, (b, s)).astype(np.int32)


class _Ref:
    """One config's reference runs: params, the greedy tokens of
    ``greedy_generate`` and, teacher-forced on them, each decode step's
    logits and caches."""

    def __init__(self, name):
        self.jcfg, self.cfg = _cfgs(name)
        self.jparams = jmodel.init(jax.random.PRNGKey(3), self.jcfg)
        self.params = params_from_jax(_np(self.jparams), self.cfg, device="cpu")
        self.prompt = _prompt(7)
        self.tokens = np.array(jsteps.greedy_generate(
            self.jcfg, self.jparams, jnp.asarray(self.prompt), MAX_NEW, MAX_LEN))
        decode = jax.jit(jsteps.make_decode_step(self.jcfg))
        caches = jmodel.init_cache(self.jcfg, B, MAX_LEN, jnp.float32)
        self.steps = []
        for t in range(self.tokens.shape[1] - 1):
            logits, caches = decode(self.jparams, caches,
                                    jnp.asarray(self.tokens[:, t]), t)
            self.steps.append((np.asarray(logits), _np(caches)))


_REFS: dict = {}


@pytest.fixture(scope="module")
def ref():
    def get(name):
        if name not in _REFS:
            _REFS[name] = _Ref(name)
        return _REFS[name]
    yield get
    _REFS.clear()


def _caches_close(got, want):
    """Per leaf: ``kpos`` exactly, the recurrent states within SEQ_TOL, the
    rest within TOL."""
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path.endswith("kpos"):
            assert torch.equal(g, w), path
            continue
        tol = SEQ_TOL if path.endswith(("ssm", "wkv")) else TOL
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol,
                                   err_msg=path)


# --------------------------------------------------------------------------- #
# Caches and decode
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CFGS))
def test_init_cache_matches_reference(name, kv_dtype):
    jcfg, cfg = _cfgs(name)
    want = _np(jmodel.init_cache(jcfg, 3, 20, jnp.dtype(kv_dtype)))
    got = model.init_cache(cfg, 3, 20, getattr(torch, kv_dtype), device="cpu")
    conv = caches_from_jax(want, cfg, device="cpu")
    assert [p for p, _ in tree_paths(got)] == [p for p, _ in tree_paths(conv)]
    for (path, g), (_, w) in zip(tree_paths(got), tree_paths(conv)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert torch.equal(g, w), path


def test_sliding_window_cache_is_a_ring_of_the_window():
    _, cfg = _cfgs("sliding")
    c = model.init_cache(cfg, 2, 100, device="cpu")[0]["attn"]
    assert c["k"].shape == (2, WINDOW, cfg.n_kv_heads, cfg.head_dim)
    assert c["kpos"].shape == (2, WINDOW) and bool((c["kpos"] == -1).all())
    assert attention.init_cache(cfg, 2, 10, device="cpu")["k"].shape[1] == 10


@pytest.mark.parametrize("name", list(CFGS))
def test_decode_steps_match_reference(ref, name):
    """Teacher-forced on the reference's greedy tokens: every step's logits
    at 1e-5 and the caches after every step (``caches_from_jax``)."""
    r = ref(name)
    caches = model.init_cache(r.cfg, B, MAX_LEN, torch.float32, device="cpu")
    decode = steps.make_decode_step(r.cfg)
    for t, (want_logits, want_caches) in enumerate(r.steps):
        logits, caches = decode(r.params, caches, torch.as_tensor(r.tokens[:, t]), t)
        np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL, atol=TOL,
                                   err_msg=f"step {t}")
        _caches_close(caches, caches_from_jax(want_caches, r.cfg, device="cpu"))
    if name == "sliding":
        # the ring wrapped: it holds the last WINDOW positions
        kpos = caches[0]["attn"]["kpos"]
        last = len(r.steps) - 1
        assert sorted(kpos[0].tolist()) == list(range(last - WINDOW + 1, last + 1))


@pytest.mark.parametrize("name", list(CFGS))
def test_greedy_generate_token_identical(ref, name):
    r = ref(name)
    got = steps.greedy_generate(r.cfg, r.params, r.prompt, MAX_NEW, MAX_LEN)
    assert got.shape == (B, PROMPT + MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), r.tokens)


def test_decode_step_with_per_row_positions_matches_reference(ref):
    """Continuous batching: rows at different depths in one step."""
    r = ref("dense")
    jcaches = jmodel.init_cache(r.jcfg, B, MAX_LEN, jnp.float32)
    caches = model.init_cache(r.cfg, B, MAX_LEN, torch.float32, device="cpu")
    jdecode = jax.jit(jsteps.make_decode_step(r.jcfg))
    pos = np.array([0, 3], np.int32)
    for t in range(5):
        tok = r.tokens[:, t]
        jl, jcaches = jdecode(r.jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        logits, caches, _ = model.decode_step(r.params, r.cfg, torch.as_tensor(tok),
                                              caches, torch.as_tensor(pos))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        _caches_close(caches, caches_from_jax(_np(jcaches), r.cfg, device="cpu"))
        pos = pos + 1


@pytest.mark.parametrize("pos", [3, [1, 2], [[1], [2]], [1, 2, 3], [4]],
                         ids=["scalar", "per_row", "B_by_1", "B_plus_1", "one"])
def test_check_decode_pos_rejects_what_the_reference_rejects(pos):
    ok = np.ndim(pos) == 0 or np.shape(pos) == (2,)
    if ok:
        want = np.asarray(jattention.check_decode_pos(jnp.asarray(pos), 2))
        got = attention.check_decode_pos(torch.as_tensor(pos), 2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    with pytest.raises(ValueError, match="decode_pos must be a scalar"):
        jattention.check_decode_pos(jnp.asarray(pos), 2)
    with pytest.raises(ValueError, match="decode_pos must be a scalar"):
        attention.check_decode_pos(torch.as_tensor(pos), 2)


def test_kv_cache_bytes_matches_reference():
    for name in ("dense", "sliding", "moe"):
        jcfg, cfg = _cfgs(name)
        for s, bpv in ((1, 2), (1024, 2), (333, 4)):
            assert attention.kv_cache_bytes(cfg, s, bpv) == \
                jattention.kv_cache_bytes(jcfg, s, bpv)


# --------------------------------------------------------------------------- #
# Prefill
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("last_only,lengths", [(True, None), (True, [9, 5]),
                                               (False, None)],
                         ids=["last", "last_lengths", "full"])
@pytest.mark.parametrize("name", ["dense", "hybrid", "rwkv6"])
def test_prefill_step_matches_reference(ref, name, last_only, lengths):
    """``make_prefill_step`` (the port's kernel path, the plain versions on
    the CPU) against the reference's (its XLA attention and scans): the
    last-only logits at each row's own length, or the full logits."""
    r = ref(name)
    toks = _prompt(11, s=9)
    batch = {"tokens": toks}
    if lengths is not None:
        batch["lengths"] = np.asarray(lengths, np.int32)
    want = np.asarray(jsteps.make_prefill_step(r.jcfg, last_only=last_only)(
        r.jparams, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = steps.make_prefill_step(r.cfg, last_only=last_only)(r.params, batch)
    assert got.grad_fn is None and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=SEQ_TOL, atol=SEQ_TOL)


@pytest.mark.parametrize("name", ["dense", "sliding", "hybrid", "rwkv6"])
def test_prefill_logits_match_teacher_forced_decode(ref, name):
    """The port's two prefills agree: the forward over the prompt (the
    kernel path) and the cache-filling teacher-forced decode."""
    r = ref(name)
    toks = _prompt(12, s=20)
    want, _ = steps.prefill_into_cache(r.cfg, r.params, toks, MAX_LEN)
    got = steps.make_prefill_step(r.cfg)(r.params, {"tokens": toks})
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), rtol=SEQ_TOL,
                               atol=SEQ_TOL)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("S,chunk", [(24, 8), (20, 32), (21, 8)])
def test_ssm_scan_chunked_matches_reference(S, chunk, with_h0):
    rng = np.random.default_rng(S + chunk)
    b, di, N = 2, 12, 4
    u = rng.standard_normal((b, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, di)) - 2)).astype(np.float32)
    Bt, Ct = (rng.standard_normal((b, S, N)).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.standard_normal((di, N)) * 0.3).astype(np.float32)
    D = rng.standard_normal(di).astype(np.float32)
    h0 = rng.standard_normal((b, di, N)).astype(np.float32) if with_h0 else None
    jy, jh = jmamba.ssm_scan_chunked(*map(jnp.asarray, (u, dt, Bt, Ct, A, D)),
                                     chunk=chunk,
                                     h0=None if h0 is None else jnp.asarray(h0))
    y, h = mamba.ssm_scan_chunked(*map(torch.as_tensor, (u, dt, Bt, Ct, A, D)),
                                  chunk=chunk,
                                  h0=None if h0 is None else torch.as_tensor(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=SEQ_TOL, atol=SEQ_TOL)


@pytest.mark.parametrize("with_state0", [False, True])
@pytest.mark.parametrize("S,chunk", [(24, 8), (20, 32), (21, 8)])
def test_wkv_chunked_matches_reference(S, chunk, with_state0):
    rng = np.random.default_rng(S * chunk)
    b, H, M = 2, 2, 8
    r, k, v = (rng.standard_normal((b, S, H, M)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.uniform(-6, -1, (b, S, H, M))).astype(np.float32)
    u = (rng.standard_normal((H, M)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, H, M, M)).astype(np.float32) if with_state0 else None
    jy, js = jrwkv6.wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u)), chunk=chunk,
                                state0=None if s0 is None else jnp.asarray(s0))
    y, s = rwkv6.wkv_chunked(*map(torch.as_tensor, (r, k, v, logw, u)), chunk=chunk,
                             state0=None if s0 is None else torch.as_tensor(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=SEQ_TOL, atol=SEQ_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=SEQ_TOL, atol=SEQ_TOL)


@pytest.mark.parametrize("name", ["hybrid", "rwkv6"])
def test_chunked_impl_prefill_matches_reference(ref, name):
    """``ssm_impl="chunked"``: the model's prefill through the chunked scans
    against the reference's."""
    r = ref(name)
    toks = _prompt(13, s=12)
    jctx = jmodel.FwdCtx(mode="prefill", remat=False, ssm_impl="chunked")
    want = np.asarray(jsteps.make_prefill_step(r.jcfg, jctx, last_only=False)(
        r.jparams, {"tokens": jnp.asarray(toks)}))
    ctx = FwdCtx(mode="prefill", remat=False, ssm_impl="chunked")
    got = steps.make_prefill_step(r.cfg, ctx, last_only=False)(r.params,
                                                               {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want, rtol=SEQ_TOL, atol=SEQ_TOL)


# --------------------------------------------------------------------------- #
# Chunked prefill and cache rows
# --------------------------------------------------------------------------- #
def _continue(cfg, params, logits, caches, pos, n=4):
    decode = steps.make_decode_step(cfg)
    tok = torch.argmax(logits, dim=-1)
    out = []
    for _ in range(n):
        out.append(tok.tolist())
        logits, caches = decode(params, caches, tok, pos)
        tok = torch.argmax(logits, dim=-1)
        pos += 1
    return out


@pytest.mark.parametrize("length", [5, 13, 26])
@pytest.mark.parametrize("name", ["dense", "sliding", "hybrid", "rwkv6"])
def test_prefill_into_cache_chunked_token_identical(ref, name, length):
    """One chunk, ragged and several chunks: the same logits and caches,
    bit for bit, and the same greedy continuation."""
    r = ref(name)
    toks = _prompt(length, b=1, s=length)
    l1, c1 = steps.prefill_into_cache(r.cfg, r.params, toks, MAX_LEN)
    l2, c2 = steps.prefill_into_cache_chunked(r.cfg, r.params, toks, MAX_LEN,
                                              chunk=8)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c1), tree_leaves(c2)))
    assert _continue(r.cfg, r.params, l1, c1, length) == \
        _continue(r.cfg, r.params, l2, c2, length)


def test_pow2_chunks_match_reference():
    for length in range(0, 70):
        for chunk in (1, 8, 16):
            assert steps.pow2_chunks(length, chunk) == jsteps.pow2_chunks(length, chunk)
    with pytest.raises(ValueError):
        steps.pow2_chunks(4, 0)


def test_steps_doctests():
    res = doctest.testmod(steps)
    assert res.attempted > 0 and res.failed == 0


@pytest.mark.parametrize("name", ["sliding", "hybrid", "rwkv6"])
def test_cache_rows_move_bit_exactly(ref, name):
    """A B=1 prefill cache with a smaller capacity merged into row 1 of a
    decode batch, extracted, then the row cleared: every leaf equals the
    reference helpers' results on the same caches, bit for bit."""
    r = ref(name)
    toks = _prompt(21, b=1, s=5)
    jl, jsrc = jsteps.prefill_into_cache(r.jcfg, r.jparams, jnp.asarray(toks), 8)
    jdst = jax.jit(jsteps.make_decode_step(r.jcfg))(
        r.jparams, jmodel.init_cache(r.jcfg, 3, MAX_LEN, jnp.float32),
        jnp.asarray([4, 5, 6], jnp.int32), 0)[1]
    src = caches_from_jax(_np(jsrc), r.cfg, device="cpu")
    dst = caches_from_jax(_np(jdst), r.cfg, device="cpu")

    def same(got, want):
        want = caches_from_jax(_np(want), r.cfg, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(want)))

    jmerged = jsteps.merge_cache_row(jdst, jsrc, row=1)
    merged = steps.merge_cache_row(dst, src, row=1)
    same(merged, jmerged)
    same(steps.extract_cache_row(merged, 1), jsteps.extract_cache_row(jmerged, 1))
    moved = steps.merge_cache_row(merged, merged, row=0, src_row=2)
    jmoved = jsteps.merge_cache_row(jmerged, jmerged, row=0, src_row=2)
    same(moved, jmoved)
    same(steps.clear_cache_row(moved, 1), jsteps.clear_cache_row(jmoved, 1))


def test_extract_cache_row_is_a_copy(ref):
    """A parked row survives the compaction that overwrites its slot."""
    r = ref("dense")
    caches = model.init_cache(r.cfg, 2, MAX_LEN, torch.float32, device="cpu")
    _, caches = steps.make_decode_step(r.cfg)(r.params, caches,
                                              torch.tensor([3, 4]), 0)
    row = steps.extract_cache_row(caches, 1)
    before = [t.clone() for t in tree_leaves(row)]
    steps.clear_cache_row(caches, 1)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(row)))


def test_moe_decode_runs_the_capacity_path(ref):
    """MoE in decode: the capacity dispatch on (B, 1, d), its stats finite."""
    r = ref("moe")
    caches = model.init_cache(r.cfg, B, MAX_LEN, torch.float32, device="cpu")
    _, _, aux = model.decode_step(r.params, r.cfg, torch.as_tensor(r.tokens[:, 0]),
                                  caches, 0)
    assert np.isfinite(aux["moe_drop_rate"].item())
    assert np.isfinite(aux["moe_imbalance"].item())
