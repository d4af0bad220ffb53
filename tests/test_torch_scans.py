"""The port's scan kernels K4–K7 (their plain versions, on the CPU) against
the reference's Pallas kernels in interpret mode and against ``jax.grad`` of
the ``kernels/ref.py`` oracles.

Inputs are numpy arrays from a seed, handed to both packages.  The cases
follow ``tests/test_kernels.py``'s ``RWKV_CASES`` and ``MAMBA_CASES`` plus
prime lengths.  The port runs at its own chunk (the CUDA kernels' chunk);
the reference at the case's chunk: no output depends on the chunk.
Tolerances, elementwise atol = rtol:
  fp32 forward 1e-4 (summation order); fp32 gradients 1e-3 (the
  reference's own bound for its kernels against the oracles);
  bf16 forward 2e-2 (both packages compute in fp32 and round y to bf16 once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import mamba_scan as jmamba
from repro.kernels import ref
from repro.kernels import rwkv6_scan as jrwkv
from repro_torch.kernels import blocking, bench
from repro_torch.kernels import mamba_scan, rwkv6_scan

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

FWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = 1e-3


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(x, np.float32), dtype=dtype, requires_grad=grad)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=name)


# --------------------------------------------------------------------------- #
# RWKV6: K6 / K7
# --------------------------------------------------------------------------- #
def _rwkv_inputs(seed, B, S, H, M):
    g = _rng(seed)
    r, k, v = (g.standard_normal((B, H, S, M)).astype(np.float32) for _ in range(3))
    w = (1 / (1 + np.exp(-g.standard_normal((B, H, S, M))))).astype(np.float32)
    u = (g.standard_normal((H, M)) * 0.1).astype(np.float32)
    return r, k, v, w, u


RWKV_CASES = [
    # (B, S, H, M, reference chunk, dtype)
    (1, 64, 2, 32, 32, "float32"),
    (2, 128, 4, 64, 32, "float32"),
    (1, 96, 2, 64, 48, "float32"),                  # non-pow2 seq/chunk
    (1, 64, 2, 32, 64, "bfloat16"),
    (2, 61, 2, 16, 16, "float32"),                  # prime seq
]


@pytest.mark.parametrize("B,S,H,M,chunk,dtype", RWKV_CASES)
def test_rwkv6_plain_forward_matches_pallas(B, S, H, M, chunk, dtype):
    r, k, v, w, u = _rwkv_inputs(3, B, S, H, M)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_j, s_j = jrwkv.rwkv6_scan_bhsm(*(jnp.asarray(x, jd) for x in (r, k, v, w, u)),
                                     chunk=chunk, interpret=True)
    y, s = rwkv6_scan.rwkv6_scan_bhsm(*(_t(x, td) for x in (r, k, v, w, u)))
    assert y.dtype == td and s.dtype == torch.float32
    _close(y.float().numpy(), y_j, FWD_TOL[dtype], "y")
    _close(s.numpy(), s_j, FWD_TOL[dtype], "s_final")


def _rwkv_oracle(r, k, v, w, u):
    """``ref.rwkv6_scan_ref`` (the reference's XLA scan) in the kernel layout."""
    y, s = ref.rwkv6_scan_ref(*(t.transpose(0, 2, 1, 3) for t in (r, k, v, w)), u)
    return y.transpose(0, 2, 1, 3), s


def _rwkv_loss(y, s, cy, cs):
    """Σ y·cy (+ Σ s·cs): a nonzero final-state cotangent, or none at all."""
    out = (y * cy).sum()
    return out if cs is None else out + (s * cs).sum()


@pytest.mark.parametrize("B,S,H,M,chunk", [(1, 64, 2, 32, 32), (2, 61, 2, 16, 16),
                                           (1, 96, 2, 64, 48)])
@pytest.mark.parametrize("final_state", ["cotangent", "unused"])
def test_rwkv6_plain_grads_match_pallas_and_oracle(B, S, H, M, chunk, final_state):
    r, k, v, w, u = _rwkv_inputs(23, B, S, H, M)
    g = _rng(24)
    cy = g.standard_normal((B, H, S, M)).astype(np.float32)
    cs = g.standard_normal((B, H, M, M)).astype(np.float32) \
        if final_state == "cotangent" else None

    def loss(fn):
        return lambda *a: _rwkv_loss(*fn(*a), cy, cs)

    args = tuple(jnp.asarray(x) for x in (r, k, v, w, u))
    want_pallas = jax.grad(loss(lambda *a: jrwkv.rwkv6_scan_bhsm(
        *a, chunk=chunk, interpret=True)), argnums=tuple(range(5)))(*args)
    oracle = jax.grad(loss(_rwkv_oracle), argnums=tuple(range(5)))(*args)
    ts = [_t(x, grad=True) for x in (r, k, v, w, u)]
    y, s = rwkv6_scan.rwkv6_scan_bhsm(*ts)
    _rwkv_loss(y, s, _t(cy), None if cs is None else _t(cs)).backward()
    for t, a, b, name in zip(ts, want_pallas, oracle, ("dr", "dk", "dv", "dw", "du")):
        _close(t.grad.numpy(), a, GRAD_TOL, name + " vs Pallas")
        _close(t.grad.numpy(), b, GRAD_TOL, name + " vs oracle")


@pytest.mark.parametrize("S", [8, 13, 40])
def test_rwkv6_outputs_do_not_depend_on_chunk(S):
    ins = [_t(x, grad=True) for x in _rwkv_inputs(5, 2, S, 2, 16)]
    outs = []
    for chunk in (1, 8, rwkv6_scan.CHUNK, 64):
        ts = [t.detach().clone().requires_grad_(True) for t in ins]
        y, s = rwkv6_scan.rwkv6_scan_bhsm(*ts, chunk=chunk)
        (y.sin().sum() + s.cos().sum()).backward()
        outs.append([y.detach(), s.detach()] + [t.grad for t in ts])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            _close(a.numpy(), b.numpy(), 1e-5)


# --------------------------------------------------------------------------- #
# Mamba: K4 / K5
# --------------------------------------------------------------------------- #
def _mamba_inputs(seed, B, S, di, N):
    g = _rng(seed)
    u = g.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((B, S, di)) - 1)).astype(np.float32)
    B_t, C_t = (g.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    A = (-np.exp(g.standard_normal((di, N)) * 0.3)).astype(np.float32)
    D = g.standard_normal((di,)).astype(np.float32)
    return u, dt, B_t, C_t, A, D


MAMBA_CASES = [
    # (B, S, di, N, reference chunk, reference c_blk, dtype)
    (1, 64, 64, 8, 32, 32, "float32"),
    (2, 128, 128, 16, 64, 64, "float32"),
    (1, 96, 64, 16, 48, 32, "float32"),
    (1, 64, 128, 16, 32, 128, "bfloat16"),
    (2, 67, 24, 8, 32, 16, "float32"),              # prime seq, non-multiple channels
]


@pytest.mark.parametrize("B,S,di,N,chunk,c_blk,dtype", MAMBA_CASES)
def test_mamba_plain_forward_matches_pallas(B, S, di, N, chunk, c_blk, dtype):
    u, dt, B_t, C_t, A, D = _mamba_inputs(5, B, S, di, N)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y_j = jmamba.mamba_scan_bsd(*(jnp.asarray(x, jd) for x in (u, dt, B_t, C_t)),
                                A, D, chunk=chunk, c_blk=c_blk, interpret=True)
    y = mamba_scan.mamba_scan_bsd(*(_t(x, td) for x in (u, dt, B_t, C_t)),
                                  _t(A), _t(D))
    assert y.dtype == td
    _close(y.float().numpy(), y_j, FWD_TOL[dtype])


@pytest.mark.parametrize("B,S,di,N,chunk,c_blk", [(1, 64, 32, 8, 32, 32),
                                                  (2, 67, 24, 8, 32, 16),
                                                  (1, 32, 17, 4, 16, 8)])
def test_mamba_plain_grads_match_pallas_and_oracle(B, S, di, N, chunk, c_blk):
    ins = _mamba_inputs(21, B, S, di, N)
    cy = _rng(22).standard_normal((B, S, di)).astype(np.float32)

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a) * cy)

    args = tuple(jnp.asarray(x) for x in ins)
    argnums = tuple(range(6))
    want_pallas = jax.grad(loss(lambda *a: jmamba.mamba_scan_bsd(
        *a, chunk=chunk, c_blk=c_blk, interpret=True)), argnums=argnums)(*args)
    oracle = jax.grad(loss(lambda *a: ref.mamba_scan_ref(*a)[0]),
                      argnums=argnums)(*args)
    ts = [_t(x, grad=True) for x in ins]
    (mamba_scan.mamba_scan_bsd(*ts) * _t(cy)).sum().backward()
    for t, a, b, name in zip(ts, want_pallas, oracle,
                             ("du", "ddt", "dB", "dC", "dA", "dD")):
        _close(t.grad.numpy(), a, GRAD_TOL, name + " vs Pallas")
        _close(t.grad.numpy(), b, GRAD_TOL, name + " vs oracle")


@pytest.mark.parametrize("S", [7, 16, 33])
def test_mamba_outputs_do_not_depend_on_chunk(S):
    ins = [_t(x) for x in _mamba_inputs(7, 2, S, 12, 4)]
    outs = []
    for chunk in (1, 16, 64):
        ts = [t.clone().requires_grad_(True) for t in ins]
        y = mamba_scan.mamba_scan_bsd(*ts, chunk=chunk)
        y.sin().sum().backward()
        outs.append([y.detach()] + [t.grad for t in ts])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            _close(a.numpy(), b.numpy(), 1e-5)


def test_mamba_plain_h_init_does_not_depend_on_chunk():
    """The chunk-initial states at chunk 1, taken every 16th step, are those
    at chunk 16 bitwise: the state itself does not depend on the chunk (K4
    saves it where a countdown names a chunk's start)."""
    ins = [_t(x) for x in _mamba_inputs(11, 2, 48, 12, 16)]
    y1, h1 = mamba_scan.fwd_plain(*ins, 1)
    y16, h16 = mamba_scan.fwd_plain(*ins, 16)
    assert h1.shape == (2, 48, 12, 16) and h16.shape == (2, 3, 12, 16)
    assert torch.equal(h1[:, ::16], h16)
    assert torch.equal(y1, y16)


# --------------------------------------------------------------------------- #
# Wrappers, padding, work counts
# --------------------------------------------------------------------------- #
def test_scan_pad_values_are_identity_steps():
    """The blocking pad values leave the state untouched: padding an input
    by hand changes neither the final state nor the real outputs."""
    r, k, v, w, u = (_t(x) for x in _rwkv_inputs(9, 1, 5, 2, 8))
    y, s = rwkv6_scan.fwd_plain(r, k, v, w, u, 5)[:2]
    pad = [blocking.pad_axis(t, 9, axis=2) for t in (r, k, v)]
    y_p, s_p = rwkv6_scan.fwd_plain(*pad, blocking.pad_axis(
        w, 9, axis=2, value=blocking.RWKV6_PAD_W), u, 9)[:2]
    _close(y_p[:, :, :5].numpy(), y.numpy(), 1e-6)
    _close(s_p.numpy(), s.numpy(), 1e-6)
    ins = [_t(x) for x in _mamba_inputs(9, 1, 5, 6, 4)]
    y = mamba_scan.fwd_plain(*ins, 5)[0]
    u_, dt, B_t, C_t = (blocking.pad_axis(t, 9, axis=1) for t in ins[:4])
    dt = blocking.pad_axis(ins[1], 9, axis=1, value=blocking.MAMBA_PAD_DT)
    _close(mamba_scan.fwd_plain(u_, dt, B_t, C_t, *ins[4:], 9)[0][:, :5].numpy(),
           y.numpy(), 1e-6)


@pytest.mark.parametrize("scan", ["rwkv6", "mamba"])
def test_scan_wrappers_reject_other_devices(scan):
    if scan == "rwkv6":
        x = torch.zeros(1, 1, 4, 32, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            rwkv6_scan.rwkv6_scan_bhsm(x, x, x, x, torch.zeros(1, 32, device="meta"))
    else:
        x = torch.zeros(1, 4, 8, device="meta")
        bc = torch.zeros(1, 4, 16, device="meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            mamba_scan.mamba_scan_bsd(x, x, bc, bc, torch.zeros(8, 16, device="meta"),
                                      torch.zeros(8, device="meta"))


def test_cuda_checks_reject_what_the_kernels_do_not_take():
    r = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    w32, u32 = torch.zeros(1, 2, 8, 64), torch.zeros(2, 64)
    rwkv6_scan._check(r, r, r, w32, u32, rwkv6_scan.CHUNK)          # accepted
    with pytest.raises(ValueError, match="f32 w and u"):
        rwkv6_scan._check(r, r, r, w32.bfloat16(), u32, rwkv6_scan.CHUNK)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_scan._check(r[..., :16], r[..., :16], r[..., :16], w32[..., :16],
                          u32[:, :16], rwkv6_scan.CHUNK)
    # K7 holds a chunk's history in registers, a sub-chunk at a time: 16 steps at
    # most; K6 takes any chunk
    rwkv6_scan._check(r, r, r, w32, u32, 64)
    rwkv6_scan._check(r, r, r, w32, u32, rwkv6_scan.K7_CHUNK, bwd=True)
    with pytest.raises(ValueError, match="history"):
        rwkv6_scan._check(r, r, r, w32, u32, rwkv6_scan.K7_CHUNK + 1, bwd=True)
    with pytest.raises(ValueError, match="chunk 0"):
        rwkv6_scan._check(r, r, r, w32, u32, 0)
    u = torch.zeros(1, 8, 32, dtype=torch.bfloat16)
    bc = torch.zeros(1, 8, 16, dtype=torch.bfloat16)
    A, D = torch.zeros(32, 16), torch.zeros(32)
    mamba_scan._check(u, u, bc, bc, A, D, mamba_scan.CHUNK)          # accepted
    with pytest.raises(ValueError, match="f32 A and D"):
        mamba_scan._check(u, u, bc, bc, A, D.bfloat16(), mamba_scan.CHUNK)
    with pytest.raises(ValueError, match="share one dtype"):
        mamba_scan._check(u, u.float(), bc, bc, A, D, mamba_scan.CHUNK)
    with pytest.raises(ValueError, match="state width"):
        mamba_scan._check(u, u, bc[..., :8], bc[..., :8], A[:, :8], D,
                          mamba_scan.CHUNK)
    # K5 holds a chunk's history in registers: 16 steps at most; K4 takes any
    mamba_scan._check(u, u, bc, bc, A, D, 64)
    mamba_scan._check(u, u, bc, bc, A, D, mamba_scan.K5_CHUNK, bwd=True)
    with pytest.raises(ValueError, match="history"):
        mamba_scan._check(u, u, bc, bc, A, D, mamba_scan.K5_CHUNK + 1, bwd=True)
    with pytest.raises(ValueError, match="chunk 0"):
        mamba_scan._check(u, u, bc, bc, A, D, 0)


def test_scan_work_counts_match_reference():
    from repro.kernels import bench as jbench
    assert bench.mamba_flops(2, 4096, 8192, 16) == jbench.mamba_flops(2, 4096, 8192, 16)
    assert bench.rwkv6_flops(2, 64, 4096, 64) == jbench.rwkv6_flops(2, 64, 4096, 64)
    # what the WKV recurrence needs per state element and step: 5 forward, 11 backward
    m = 2 * 64 * 4096 * 64 * 64
    assert bench.rwkv6_fwd_ops(2, 64, 4096, 64) == 5 * m
    assert bench.rwkv6_bwd_ops(2, 64, 4096, 64) == 11 * m
    # bf16 sequences at the RWKV6-7B shape: r, k, v, y (2 B) + w (4 B) + u + state
    n = 2 * 64 * 4096 * 64
    assert bench.rwkv6_fwd_bytes(2, 64, 4096, 64, 2) == 2 * 4 * n + 4 * (
        n + 64 * 64 + 2 * 64 * 64 * 64)


@pytest.mark.parametrize("S,n_chunks", [(4096, 256), (4097, 257)])
def test_mamba_fwd_floor_counts_match_hand_counts(S, n_chunks):
    """K4's other floors at Jamba's scan shape (B 2, di 8192, N 16, chunk 16):
    the fp32 chunk-initial states it writes (4 bytes × B × n_chunks × di × N,
    a ragged tail starting a chunk of its own) and one exponential a state
    element and step."""
    assert bench.mamba_fwd_h_init_bytes(2, S, 8192, 16, 16) == 4 * 2 * n_chunks * 8192 * 16
    assert bench.mamba_fwd_exps(2, S, 8192, 16) == 2 * S * 8192 * 16
    # the byte bound stays what K4's own inputs and output take: u, dt, y and
    # B_t, C_t in bf16, A and D in fp32
    assert bench.mamba_fwd_bytes(2, S, 8192, 16, 2) == 2 * (3 * 2 * S * 8192 + 2 * 2 * S * 16) \
        + 4 * (8192 * 16 + 8192)
