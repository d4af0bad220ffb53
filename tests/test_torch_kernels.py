"""Port's packed flash attention (K1–K3) against the reference.

On the CPU the port's wrappers run the kernels' plain versions; the
reference runs its Pallas kernels in interpret mode.  Same numpy inputs go
through both.  Tolerances (fp32): forward atol = rtol = 1e-5, gradients
2e-3 (the reference suite's own bound for gradients through Pallas).

The CUDA kernels themselves are held against the plain versions in
``test_torch_cuda.py`` (on a card) and by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import packed_flash_attention as jpfa
from repro_torch.kernels import blocking
from repro_torch.kernels import ops
from repro_torch.kernels import packed_flash_attention as pfa

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 2e-3


def _qkv(seed, B, S, H, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KH, D)).astype(np.float32),
            rng.standard_normal((B, S, KH, D)).astype(np.float32))


def _segments(seed, B, S, n_seg):
    """Contiguous segments 1..n_seg, then a 0 (padding) tail."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((B, S), np.int32)
    for b in range(B):
        cur = 0
        for i in range(n_seg):
            L = int(rng.integers(1, max(2, S // n_seg + 1)))
            seg[b, cur:cur + L] = i + 1
            cur += L
            if cur >= S:
                break
    return seg


def _jax_fwd_grad(fn, args):
    """Output and the grads of sum(sin(y)) w.r.t. every arg."""
    y, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(y), [np.asarray(g) for g in vjp(jnp.cos(y))]


def _torch_fwd_grad(fn, args):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    y = fn(*ts)
    grads = torch.autograd.grad(torch.sin(y).sum(), ts)
    return y.detach().numpy(), [g.numpy() for g in grads]


CASES = [
    # (B, S, H, KH, D, causal, window, n_seg)
    (1, 64, 4, 2, 32, True, 0, 2),       # GQA
    (2, 64, 4, 1, 32, True, 0, 3),       # MQA, packed segments
    (2, 64, 2, 2, 32, False, 0, 2),      # bidirectional (encoder)
    (1, 96, 2, 1, 32, True, 48, 2),      # window spans 32-blocks
    (1, 127, 2, 2, 32, True, 0, 2),      # prime length (pad path)
    # the other head dims of the reference's configs: the tiny encoder of
    # examples/train_mllm.py (24), SigLIP (72, here with Qwen2.5's G = 7),
    # HuBERT-xlarge (80), gemma-2b (256, MQA)
    (1, 64, 4, 2, 24, False, 0, 2),
    (1, 64, 7, 1, 72, True, 0, 2),
    (2, 64, 2, 2, 72, False, 0, 3),
    (1, 96, 2, 1, 80, True, 48, 2),
    (1, 64, 2, 1, 256, True, 0, 2),
]


@pytest.mark.parametrize("B,S,H,KH,D,causal,window,n_seg", CASES)
def test_plain_matches_pallas_fwd_and_grads(B, S, H, KH, D, causal, window,
                                            n_seg):
    q, k, v = _qkv(11, B, S, H, KH, D)
    seg = _segments(13, B, S, n_seg)
    y_ref, g_ref = _jax_fwd_grad(
        lambda q, k, v: jops.packed_flash_attention(
            q, k, v, segment_ids=jnp.asarray(seg), causal=causal,
            window=window, block_q=32, block_k=32), (q, k, v))
    y, g = _torch_fwd_grad(
        lambda q, k, v: ops.packed_flash_attention(
            q, k, v, segment_ids=torch.tensor(seg), causal=causal,
            window=window, block_q=32, block_k=32), (q, k, v))
    np.testing.assert_allclose(y, y_ref, rtol=FWD_TOL, atol=FWD_TOL)
    for a, b, name in zip(g, g_ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_fully_masked_query_tile():
    """A query tile whose segment matches no key: exact-zero output and dq,
    finite grads, agreement with the reference kernel."""
    B, KH, G, S, D = 1, 2, 1, 64, 32
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, KH, G, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KH, S, D)).astype(np.float32)
    seg_q = np.r_[np.full(32, 7), np.ones(32)].astype(np.int32)[None]
    seg_k = np.ones((B, S), np.int32)
    y_ref, g_ref = _jax_fwd_grad(
        lambda q, k, v: jpfa.packed_flash_attention_bkgsd(
            q, k, v, jnp.asarray(seg_q), jnp.asarray(seg_k), causal=True,
            window=0, block_q=32, block_k=32, interpret=True), (q, k, v))
    y, g = _torch_fwd_grad(
        lambda q, k, v: pfa.packed_flash_attention_bkgsd(
            q, k, v, torch.tensor(seg_q), torch.tensor(seg_k), causal=True,
            window=0, block_q=32, block_k=32), (q, k, v))
    np.testing.assert_array_equal(y[:, :, :, :32], 0.0)
    np.testing.assert_array_equal(g[0][:, :, :, :32], 0.0)
    np.testing.assert_allclose(y, y_ref, rtol=FWD_TOL, atol=FWD_TOL)
    for a, b in zip(g, g_ref):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_lse_sentinel_on_fully_masked_rows():
    B, KH, G, S, D = 1, 1, 2, 16, 8
    q = torch.randn(B, KH, G, S, D)
    k = torch.randn(B, KH, S, D)
    seg_q = torch.tensor([[5] * 4 + [1] * 12], dtype=torch.int32)
    seg_k = torch.ones((B, S), dtype=torch.int32)
    o, lse = pfa.flash_fwd(q, k, k, seg_q, seg_k, True, 0, 8, 8)
    assert torch.all(lse[..., :4] == pfa.NEG_INF)
    assert torch.all(o[..., :4, :] == 0)
    assert torch.all(torch.isfinite(lse[..., 4:]))


@pytest.mark.parametrize("blocks", [(16, 16), (64, 32)])
def test_outputs_do_not_depend_on_block(blocks):
    q, k, v = _qkv(3, 2, 80, 4, 2, 16)
    seg = _segments(4, 2, 80, 3)
    args = (q, k, v)

    def run(bq, bk):
        return _torch_fwd_grad(
            lambda q, k, v: ops.packed_flash_attention(
                q, k, v, segment_ids=torch.tensor(seg), causal=True,
                block_q=bq, block_k=bk), args)

    y0, g0 = run(512, 512)
    y1, g1 = run(*blocks)
    np.testing.assert_allclose(y1, y0, rtol=FWD_TOL, atol=FWD_TOL)
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=FWD_TOL, atol=FWD_TOL)


def test_gqa_kv_head_mapping():
    """Query head h reads kv head h // G."""
    B, S, KH, G, D = 1, 32, 2, 2, 16
    q = torch.zeros(B, S, KH * G, D)
    k = torch.zeros(B, S, KH, D)
    v = torch.arange(1, KH + 1, dtype=torch.float32)[None, None, :, None].expand(
        B, S, KH, D)
    out = ops.packed_flash_attention(q, k, v, block_q=16, block_k=16)
    want = torch.arange(1, KH + 1, dtype=torch.float32).repeat_interleave(G)
    torch.testing.assert_close(out, want[None, None, :, None].expand_as(out))


@pytest.mark.parametrize("s", [1, 63, 64, 96, 127, 257, 509])
def test_pick_block_prime_lengths_no_extra_grid_steps(s):
    for tgt in (32, 64, 128, 512):
        b, padded = blocking.pick_block(s, tgt)
        assert 1 <= b <= max(1, tgt) and padded >= s and padded % b == 0
        assert padded // b == -(-s // b)


def test_pad_axis_matches_reference_values():
    x = torch.arange(6, dtype=torch.int32).reshape(1, 6)
    y = blocking.pad_axis(x, 8, axis=1, value=blocking.PAD_SEGMENT)
    assert y.tolist() == [[0, 1, 2, 3, 4, 5, -1, -1]]
    assert blocking.pad_axis(x, 6, axis=1) is x


# The smoke's bf16 tolerances, relative to the reference output itself:
# max|err| <= 2e-2 max|ref| and ||err|| <= 1e-2 ||ref||.
BF16_TOL = (2e-2, 1e-2)


def _rounded_backward(q, k, v, seg_q, seg_k, do, lse, delta, causal):
    """The tensor-core K2/K3's arithmetic in plain torch: fp32 products of
    the bf16 operands, then p and ds rounded to bf16 before dq = ds k,
    dk = dsᵀ q (over the G heads) and dv = pᵀ do; outputs in bf16."""
    D, S = q.shape[-1], q.shape[-2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scale = D ** -0.5
    pos = torch.arange(S)
    mask = seg_q[:, None, None, :, None] == seg_k[:, None, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    p_b, ds_b = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds_b, kf)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds_b, qf)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p_b, dof)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _within_bf16_tol(got, ref, what):
    d, r = got.float() - ref.float(), ref.float()
    assert d.abs().max().item() <= BF16_TOL[0] * r.abs().max().item(), what
    assert d.norm().item() <= BF16_TOL[1] * r.norm().item(), what


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 72, 128])
def test_bf16_rounding_of_p_and_ds_stays_within_tolerance(D, causal):
    """Rounding p and ds to bf16 before the second products (what the
    tensor-core K2/K3 do) stays within the smoke's bf16 tolerances of the
    plain versions, which keep them in fp32, and of the reference's
    gradients (jax.vjp through the Pallas kernels in interpret mode).
    S = 257 (prime), G = 2, the first 40 query rows masked everywhere."""
    B, KH, G, S = 1, 2, 2, 257
    rng = np.random.default_rng(17 + D + int(causal))
    q32, do32 = (rng.standard_normal((B, KH, G, S, D)).astype(np.float32) for _ in range(2))
    k32, v32 = (rng.standard_normal((B, KH, S, D)).astype(np.float32) for _ in range(2))
    seg_k = np.ones((B, S), np.int32)
    seg_q = seg_k.copy()
    seg_q[:, :40] = 7
    q, k, v, do = (torch.tensor(a).bfloat16() for a in (q32, k32, v32, do32))
    tsq, tsk = torch.tensor(seg_q), torch.tensor(seg_k)

    o, lse = pfa.fwd_plain(q, k, v, tsq, tsk, causal, 0, S, S)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, tsq, tsk, do, lse, delta, causal, 0, S, S)
    plain = (pfa.bwd_dq_plain(*args), *pfa.bwd_dkv_plain(*args))
    rounded = _rounded_backward(q, k, v, tsq, tsk, do, lse, delta, causal)

    bf = jnp.bfloat16
    _, vjp = jax.vjp(
        lambda q, k, v: jpfa.packed_flash_attention_bkgsd(
            q, k, v, jnp.asarray(seg_q), jnp.asarray(seg_k), causal=causal,
            window=0, block_q=64, block_k=64, interpret=True),
        *(jnp.asarray(a, dtype=bf) for a in (q32, k32, v32)))
    ref = [torch.tensor(np.asarray(g.astype(jnp.float32)))
           for g in vjp(jnp.asarray(do32, dtype=bf))]

    for name, r, p, j in zip(("dq", "dk", "dv"), rounded, plain, ref):
        _within_bf16_tol(r, p, f"{name} vs the plain version")
        _within_bf16_tol(r, j, f"{name} vs the reference")
    assert torch.all(rounded[0][..., :40, :] == 0)       # masked rows: exact zeros


def _rounded_forward(q, k, v, seg_q, seg_k, causal, bk=64):
    """The tensor-core K1's arithmetic in plain torch: fp32 scores of the
    bf16 operands, the online softmax over 64-key tiles, l summed from the
    fp32 p, then p rounded to bf16 before o += p v; o in bf16, lse f32."""
    D, S = q.shape[-1], q.shape[-2]
    qf, kf, vf = (t.float() for t in (q, k, v))
    pos = torch.arange(S)
    m = torch.full(q.shape[:-1], pfa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j0 in range(0, S, bk):
        sl = slice(j0, j0 + bk)
        mask = seg_q[:, None, None, :, None] == seg_k[:, None, None, None, sl]
        if causal:
            mask = mask & (pos[sl][None, :] <= pos[:, None])
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf[:, :, sl]) * D ** -0.5
        s = torch.where(mask, s, pfa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bksd->bkgqd", p.bfloat16().float(), vf[:, :, sl])
        m = m_new
    live = l > 0
    den = torch.clamp(l, min=1e-30)
    o = torch.where(live[..., None], acc / den[..., None], 0.0)
    return o.bfloat16(), torch.where(live, m + torch.log(den), pfa.NEG_INF)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 72, 128])
def test_bf16_rounding_of_p_in_the_forward_stays_within_tolerance(D, causal):
    """Rounding p to bf16 before P V (what the tensor-core K1 does, l kept
    from the fp32 p) stays within the smoke's bf16 tolerances of the plain
    version, which keeps p in fp32, and of the reference's output (the
    Pallas kernel in interpret mode).  S = 257 (prime), G = 2, packed
    segments, the first 40 query rows masked everywhere: o = 0 and
    lse = -1e30 exactly there."""
    B, KH, G, S = 1, 2, 2, 257
    rng = np.random.default_rng(29 + D + int(causal))
    q32 = rng.standard_normal((B, KH, G, S, D)).astype(np.float32)
    k32, v32 = (rng.standard_normal((B, KH, S, D)).astype(np.float32) for _ in range(2))
    seg_k = np.zeros((B, S), np.int32)
    for i, (a, e) in enumerate([(0, 70), (70, 71), (71, 190), (190, 240)]):
        seg_k[:, a:e] = i + 1                         # 240..256: tail, segment 0
    seg_q = seg_k.copy()
    seg_q[:, :40] = 7
    q, k, v = (torch.tensor(a).bfloat16() for a in (q32, k32, v32))
    tsq, tsk = torch.tensor(seg_q), torch.tensor(seg_k)

    o, lse = _rounded_forward(q, k, v, tsq, tsk, causal)
    o_plain, lse_plain = pfa.fwd_plain(q, k, v, tsq, tsk, causal, 0, S, S)
    bf = jnp.bfloat16
    o_ref = jpfa.packed_flash_attention_bkgsd(
        *(jnp.asarray(a, dtype=bf) for a in (q32, k32, v32)), jnp.asarray(seg_q),
        jnp.asarray(seg_k), causal=causal, window=0, block_q=64, block_k=64,
        interpret=True)
    o_ref = torch.tensor(np.asarray(o_ref.astype(jnp.float32)))

    _within_bf16_tol(o, o_plain, "o vs the plain version")
    _within_bf16_tol(o, o_ref, "o vs the reference")
    d = o.float() - o_plain.float()
    print(f"D {D} causal {causal}: ||o - plain|| / ||plain|| "
          f"{(d.norm() / o_plain.float().norm()).item():.3e}, max|o - plain| / max|plain| "
          f"{(d.abs().max() / o_plain.float().abs().max()).item():.3e}")
    dead = torch.zeros(S, dtype=torch.bool)
    dead[:40] = True
    assert torch.all(o[..., dead, :] == 0) and torch.all(lse[..., dead] == pfa.NEG_INF)
    assert torch.all(lse_plain[..., dead] == pfa.NEG_INF)
    # lse is not rounded to bf16: only the summation order differs
    torch.testing.assert_close(lse[..., ~dead], lse_plain[..., ~dead], rtol=0, atol=1e-4)


def test_route_follows_dtype_and_checks_follow_route():
    """bf16 K1, K2 and K3 take the tensor cores, fp32 the CUDA cores; the
    argument checks hold each route to its own grid and alignment, and both
    to head dims that are multiples of 8 from 8 to 256."""
    assert pfa.route_of(torch.bfloat16) == pfa.TENSOR_CORE
    assert pfa.route_of(torch.float32) == pfa.CUDA_CORE
    B, KH, G, S, D = 1, 2, 2, 16, 64
    seg = torch.ones(B, S, dtype=torch.int32)
    row = torch.zeros(B, KH, G, S)

    def args(dt, q=None, D=D):
        q = torch.zeros(B, KH, G, S, D, dtype=dt) if q is None else q
        k = torch.zeros(B, KH, S, D, dtype=dt)
        return (q, k, k, seg, seg, torch.zeros_like(q), row, row)

    for kernel in ("fwd", "bwd_dq", "bwd_dkv"):
        n = 5 if kernel == "fwd" else 8          # K1 takes no dout, lse, delta
        for dt in (torch.bfloat16, torch.float32):
            for d in (24, 32, 64, 72, 80, 128, 256):         # accepted
                pfa._check(kernel, *args(dt, D=d)[:n])
            for d in (20, 264):
                with pytest.raises(ValueError, match="multiple of 8 from 8 to 256"):
                    pfa._check(kernel, *args(dt, D=d)[:n])
        # a view that starts 2 bytes into its storage: no 16-byte cp.async
        buf = torch.zeros(B * KH * G * S * D + 1, dtype=torch.bfloat16)
        q_off = buf[1:].view(B, KH, G, S, D)
        with pytest.raises(ValueError, match="16-byte"):
            pfa._check(kernel, *args(torch.bfloat16, q_off)[:n])
    # grid y: B * KH for the tensor-core K2 and for K3, B * KH * G for K1
    # and the CUDA-core K2
    big_g = 40000
    q = torch.zeros(1, 2, big_g, 1, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 2, 1, 64, dtype=torch.bfloat16)
    s1 = torch.ones(1, 1, dtype=torch.int32)
    r1 = torch.zeros(1, 2, big_g, 1)
    pfa._check("bwd_dq", q, k, k, s1, s1, q, r1, r1)
    pfa._check("bwd_dkv", q, k, k, s1, s1, q, r1, r1)
    with pytest.raises(ValueError, match="grid y"):
        pfa._check("fwd", q, k, k, s1, s1)
    with pytest.raises(ValueError, match="grid y"):
        pfa._check("bwd_dq", q.float(), k.float(), k.float(), s1, s1, q.float(), r1, r1)
