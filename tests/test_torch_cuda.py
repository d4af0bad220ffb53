"""The CUDA kernels K1–K7 against their plain versions, on the card.

Marked ``gpu``: without a card each test skips (decided inside the test,
never at import).  This file imports no jax, so it also runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance, per output and relative to the plain output itself:
max|kernel − plain| ≤ t_max · max|plain| and ‖kernel − plain‖ ≤ t_rel · ‖plain‖,
with (t_max, t_rel) = (1e-4, 1e-5) in fp32 (summation order) and (2e-2, 1e-2)
in bf16 (one bf16 rounding of the outputs).
"""
import pytest
import torch

from repro_torch.kernels import mamba_scan, rwkv6_scan
from repro_torch.kernels import packed_flash_attention as pfa


def _assert_close(outs, dt):
    t_max, t_rel = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 1e-2)
    for a, b in zip(*outs):
        d, b = a.float() - b.float(), b.float()
        assert d.abs().max().item() <= t_max * b.abs().max().item()
        assert d.norm().item() <= t_rel * b.norm().item()


def _segments(kind, B, S):
    """(seg_q, seg_k) on the card: "two" splits each row at S // 3; "masked"
    gives the first 40 query rows an id no key has (rows masked everywhere);
    "packed" packs segments 1..5 of uneven lengths and a padded tail."""
    seg = torch.zeros(B, S, dtype=torch.int32)
    if kind == "packed":
        cuts = [0, 50, 120, 121, 260, S]
        for i in range(5):
            seg[:, cuts[i]:cuts[i + 1]] = i + 1
        seg[1:, 290:] = 0
    else:
        seg[:, S // 3:] = 1
    seg_q = seg.clone()
    if kind == "masked":
        seg[:] = 1
        seg_q[:] = 1
        seg_q[:, :40] = 7
    return seg_q.cuda(), seg.cuda()


# (B, KH, G, S, D, causal, window, segments): bf16 K1-K3 run on the tensor
# cores, fp32 on the CUDA cores; head dims 64 and 128 (their own tile
# widths) and 24, 32, 72, 80, 256 (the other head dims of the reference's
# configs: zero columns past D in a 64-, 128- or 256-wide tile), a prime
# length, a window spanning tiles, G = 4 and G = 7 (Qwen2.5-7B's), rows
# masked everywhere, packed rows
CASES = [(1, 2, 2, 131, 64, True, 0, "two"),
         (2, 2, 1, 96, 128, False, 0, "two"),
         (1, 1, 4, 200, 64, True, 37, "two"),
         (1, 2, 2, 257, 64, True, 0, "two"),
         (1, 2, 1, 300, 128, True, 100, "two"),
         (2, 1, 4, 200, 64, False, 0, "two"),
         (1, 2, 2, 200, 128, True, 0, "masked"),
         (2, 2, 2, 300, 128, True, 0, "packed"),
         (2, 1, 2, 300, 64, False, 0, "packed"),
         (1, 2, 2, 131, 24, False, 0, "two"),
         (1, 1, 2, 257, 32, True, 0, "two"),
         (1, 1, 7, 257, 72, False, 0, "two"),
         (1, 2, 2, 200, 72, True, 0, "masked"),
         (2, 2, 1, 300, 80, True, 0, "packed"),
         (1, 1, 7, 131, 128, True, 0, "two"),
         (1, 1, 8, 200, 256, True, 0, "two"),
         (1, 2, 2, 200, 256, True, 0, "masked"),
         (2, 1, 2, 300, 256, False, 0, "packed")]


def _case(gen, dt, B, KH, G, S, D):
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)  # noqa: E731
    return rnd(B, KH, G, S, D), rnd(B, KH, S, D), rnd(B, KH, S, D)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pfa.reset_launches()
    for (B, KH, G, S, D, causal, window, kind) in CASES:
        q, k, v = _case(gen, dt, B, KH, G, S, D)
        seg_q, seg_k = _segments(kind, B, S)
        outs = []
        for plain in (False, True):
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            y = pfa.packed_flash_attention_bkgsd(
                qs, ks, vs, seg_q, seg_k, causal=causal, window=window,
                block_q=64, block_k=64, plain=plain)
            grads = torch.autograd.grad(torch.sin(y.float()).sum(), (qs, ks, vs))
            outs.append([y, *grads])
        _assert_close(outs, dt)
        if kind == "masked":            # p = 0 by the select: exact zeros
            assert torch.all(outs[0][0][..., :40, :] == 0)
            assert torch.all(outs[0][1][..., :40, :] == 0)
    want = pfa.TENSOR_CORE if dt == torch.bfloat16 else pfa.CUDA_CORE
    assert {key[1] for key in pfa.LAUNCHES} == {want}
    assert {key[0] for key in pfa.LAUNCHES} == {"fwd", "bwd_dq", "bwd_dkv"}


@pytest.mark.gpu
def test_cuda_tensor_core_forward_is_deterministic():
    """bf16 K1 run twice on the same inputs gives bitwise equal o and lse;
    rows masked everywhere give o = 0 and lse = -1e30 exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(4)
    for (B, KH, G, S, D, causal, window, kind) in CASES:
        q, k, v = _case(gen, torch.bfloat16, B, KH, G, S, D)
        seg_q, seg_k = _segments(kind, B, S)
        runs = [pfa.flash_fwd(q, k, v, seg_q, seg_k, causal, window, 64, 64)
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        if kind == "masked":
            o, lse = runs[0]
            assert torch.all(o[..., :40, :] == 0)
            assert torch.all(lse[..., :40] == pfa.NEG_INF)


@pytest.mark.gpu
def test_cuda_tensor_core_backward_is_deterministic():
    """bf16 K2 and K3 run twice on the same inputs give bitwise equal dq, dk
    and dv: no atomics, every output element written once by one block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for (B, KH, G, S, D, causal, window, kind) in CASES:
        q, k, v = _case(gen, torch.bfloat16, B, KH, G, S, D)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        seg_q, seg_k = _segments(kind, B, S)
        o, lse = pfa.flash_fwd(q, k, v, seg_q, seg_k, causal, window, 64, 64)
        delta = torch.sum(do.float() * o.float(), -1).contiguous()
        args = (q, k, v, seg_q, seg_k, do, lse, delta, causal, window, 64, 64)
        runs = [(pfa.flash_bwd_dq(*args), *pfa.flash_bwd_dkv(*args)) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# (B, H, S, M, final-state cotangent, offset) of the RWKV6 scan cases: prime
# lengths over several chunks, S 1 and 5 (under a chunk), S one past a chunk (a
# full chunk after a ragged one), B 3, M 32, and r, k, v, dy one element past a
# 16-byte aligned allocation (K7's plain-load path)
RWKV_CASES = [(2, 3, 131, 64, True, False), (1, 2, 61, 32, True, False),
              (2, 2, 40, 64, False, False), (1, 2, 1, 64, True, False),
              (3, 2, 5, 64, False, False), (1, 3, rwkv6_scan.CHUNK + 1, 64, True, False),
              (3, 2, 33, 32, True, False), (2, 2, 37, 64, True, True)]


def _rwkv_inputs(gen, dt, B, H, S, M):
    """r, k, v (in ``dt``), w, u (fp32) on the card."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    return [rnd(B, H, S, M).to(dt), rnd(B, H, S, M).to(dt), rnd(B, H, S, M).to(dt),
            torch.sigmoid(rnd(B, H, S, M)), rnd(H, M) * 0.1]


def _offset_leaf(t):
    """A leaf that holds ``t``'s values one element past the start of its
    allocation, and the contiguous view of them a kernel is given (not 16-byte
    aligned)."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    with torch.no_grad():
        buf[1:] = t.flatten()
    buf.requires_grad_(True)
    view = buf[1:].view(t.shape)
    assert view.data_ptr() % 16
    return buf, view


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_scan_matches_plain(dtype):
    """K6 forward and K7 gradients, with and without a final-state
    cotangent, in the cases of ``RWKV_CASES``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (B, H, S, M, final_cot, offset) in RWKV_CASES:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        ins = _rwkv_inputs(gen, dt, B, H, S, M)
        cy, cs = rnd(B, H, S, M), rnd(B, H, M, M) if final_cot else None
        outs = []
        for plain in (False, True):
            leaves = [t.clone().requires_grad_(True) for t in ins]
            args = list(leaves)
            if offset and not plain:
                for i in range(3):
                    leaves[i], args[i] = _offset_leaf(ins[i])
            y, s = rwkv6_scan.rwkv6_scan_bhsm(*args, plain=plain)
            loss = (y.float() * cy).sum() + ((s * cs).sum() if final_cot else 0)
            grads = list(torch.autograd.grad(loss, leaves))
            if offset and not plain:
                grads[:3] = [g[1:].view(t.shape) for g, t in zip(grads[:3], ins)]
            outs.append([y, s, *grads])
        _assert_close(outs, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_backward_is_deterministic(dtype):
    """K7 run twice on the same inputs gives bitwise equal dr, dk, dv, dw and
    du partials: no atomics, every sum in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for (B, H, S, M, final_cot, offset) in RWKV_CASES:
        r, k, v, w, u = _rwkv_inputs(gen, dt, B, H, S, M)
        dy = torch.randn(B, H, S, M, generator=gen, device="cuda").to(dt)
        ds = (torch.randn(B, H, M, M, generator=gen, device="cuda") if final_cot
              else torch.zeros(B, H, M, M, device="cuda"))
        if offset:
            r, k, v, dy = (_offset_leaf(t)[1].detach() for t in (r, k, v, dy))
        chunk = min(rwkv6_scan.CHUNK, S)
        _, _, s_init = rwkv6_scan.wkv_fwd(r, k, v, w, u, chunk)
        runs = [rwkv6_scan.wkv_bwd(r, k, v, w, u, s_init, dy, ds, chunk) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_forward_is_deterministic(dtype):
    """K6 run twice on the same inputs gives bitwise equal y, s_final and
    s_init: no atomics, every sum in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (B, H, S, M, _, offset) in RWKV_CASES:
        r, k, v, w, u = _rwkv_inputs(gen, dt, B, H, S, M)
        if offset:
            r, k, v = (_offset_leaf(t)[1].detach() for t in (r, k, v))
        chunk = min(rwkv6_scan.CHUNK, S)
        runs = [rwkv6_scan.wkv_fwd(r, k, v, w, u, chunk) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# (S, chunk, M, offset) of K6's tile edges: S one under and one over a tile
# (K6_TILE steps) and past two, chunks 1 and 3 (not a multiple of the 4 steps
# whose sums K6 takes together, so a chunk starts inside such a group and an
# identity step past S must start none), 8 and 16
K6_EDGES = [(rwkv6_scan.K6_TILE - 1, 16, 64, False), (rwkv6_scan.K6_TILE + 1, 16, 64, False),
            (rwkv6_scan.K6_TILE + 1, 1, 64, False), (rwkv6_scan.K6_TILE - 1, 3, 32, False),
            (2 * rwkv6_scan.K6_TILE + 1, 3, 64, True), (2 * rwkv6_scan.K6_TILE + 1, 8, 32, False),
            (5, 3, 64, False), (1, 1, 64, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_forward_states_match_plain(dtype):
    """K6's s_init and s_final at chunks 1, 3, 8 and 16 and at S one step on
    either side of a tile match ``fwd_plain`` at fp32's tolerance in both
    types (both compute the states in fp32), y at the type's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (S, chunk, M, offset) in K6_EDGES:
        B, H = 2, 2
        r, k, v, w, u = _rwkv_inputs(gen, dt, B, H, S, M)
        kr, kk, kv = ((_offset_leaf(t)[1].detach() for t in (r, k, v)) if offset
                      else (r, k, v))
        y, s_final, s_init = rwkv6_scan.wkv_fwd(kr, kk, kv, w, u, chunk)
        S_p = -(-S // chunk) * chunk
        pad = lambda t, x=0.0: torch.nn.functional.pad(t, (0, 0, 0, S_p - S), value=x)  # noqa: E731
        y_p, f_p, i_p = rwkv6_scan.fwd_plain(pad(r), pad(k), pad(v), pad(w, 1.0), u, chunk)
        assert s_init.shape == i_p.shape == (B, H, -(-S // chunk), M, M)
        _assert_close([[s_final, s_init], [f_p, i_p]], torch.float32)
        _assert_close([[y], [y_p[:, :, :S]]], dt)


# (B, S, di) of the Mamba scan cases
MAMBA_CASES = [(2, 131, 300), (1, 64, 128), (3, 17, 40), (1, 1, 36), (3, 5, 36)]


def _mamba_inputs(gen, dt, B, S, di):
    """u, dt, B_t, C_t (in ``dt``), A, D (fp32) on the card."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    return [rnd(B, S, di).to(dt), torch.nn.functional.softplus(rnd(B, S, di) - 1).to(dt),
            rnd(B, S, 16).to(dt), rnd(B, S, 16).to(dt), -torch.exp(rnd(di, 16) * 0.3),
            rnd(di)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_scan_matches_plain(dtype):
    """K4 forward and K5 gradients; channels that do not fill a block (di 36
    is not a multiple of a warp's 8 channels in K5), S 1 and 5 (under a
    chunk), B 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for (B, S, di) in MAMBA_CASES:
        ins = _mamba_inputs(gen, dt, B, S, di)
        cy = torch.randn(B, S, di, generator=gen, device="cuda")
        outs = []
        for plain in (False, True):
            ts = [t.clone().requires_grad_(True) for t in ins]
            y = mamba_scan.mamba_scan_bsd(*ts, plain=plain)
            outs.append([y, *torch.autograd.grad((y.float() * cy).sum(), ts)])
        _assert_close(outs, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_scan_with_restarts_matches_plain(dtype):
    """K4 and K5 restarting the state at packed-segment starts (a group's
    first step, inside a group, step 1, the last step, every step of a
    row) against the plain versions with the same restart words."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for (B, S, di) in MAMBA_CASES:
        ins = _mamba_inputs(gen, dt, B, S, di)
        starts = torch.rand(B, S, generator=gen, device="cuda") < 0.1
        starts[:, 0] = False
        starts[0, [t for t in (1, 16, 17, 64, S - 1) if t < S]] = True
        if B > 2:
            starts[2, 1:] = True
        words = mamba_scan.start_words(starts)
        cy = torch.randn(B, S, di, generator=gen, device="cuda")
        outs = []
        for plain in (False, True):
            ts = [t.clone().requires_grad_(True) for t in ins]
            y = mamba_scan.mamba_scan_bsd(*ts, plain=plain, starts=words)
            outs.append([y, *torch.autograd.grad((y.float() * cy).sum(), ts)])
        _assert_close(outs, dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_backward_is_deterministic(dtype):
    """K5 run twice on the same inputs gives bitwise equal du, ddt and
    partials: no atomics, the cross-warp sums in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    for (B, S, di) in MAMBA_CASES:
        u, dts, Bt, Ct, A, D = _mamba_inputs(gen, dt, B, S, di)
        dy = torch.randn(B, S, di, generator=gen, device="cuda").to(dt)
        chunk = min(mamba_scan.CHUNK, S)
        _, h_init = mamba_scan.scan_fwd(u, dts, Bt, Ct, A, D, chunk)
        runs = [mamba_scan.scan_bwd(u, dts, Bt, Ct, A, D, h_init, dy, chunk)
                for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_forward_is_deterministic(dtype):
    """K4 run twice on the same inputs gives bitwise equal y and h_init: no
    atomics, every sum in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for (B, S, di) in MAMBA_CASES:
        u, dts, Bt, Ct, A, D = _mamba_inputs(gen, dt, B, S, di)
        chunk = min(mamba_scan.CHUNK, S)
        runs = [mamba_scan.scan_fwd(u, dts, Bt, Ct, A, D, chunk) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


# (S, chunk, di, offset) of K4's tile edges: S one under and one over a tile
# (K4_TILE steps in bf16, half in fp32) and past two, chunks 1, 3 and 8 (not a
# multiple of the 16 steps whose sums K4 takes together, so a chunk starts
# inside such a group and an identity step past S must start none) and 16,
# di 300 and 36 (not whole 16-byte rows: the plain-load path), S 1 and 5, and
# u, dt one element past a 16-byte aligned allocation (the plain-load path)
K4_EDGES = [(mamba_scan.K4_TILE - 1, 16, 256, False), (mamba_scan.K4_TILE + 1, 16, 128, False),
            (mamba_scan.K4_TILE + 1, 1, 256, False), (mamba_scan.K4_TILE - 1, 3, 300, False),
            (2 * mamba_scan.K4_TILE + 1, 3, 256, True), (2 * mamba_scan.K4_TILE + 1, 8, 128, False),
            (2 * mamba_scan.K4_TILE + 1, 16, 300, True), (5, 3, 36, False), (1, 1, 40, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_forward_states_match_plain(dtype):
    """K4's h_init at chunks 1, 3, 8 and 16 and at S one step on either side
    of a tile matches ``fwd_plain`` at fp32's tolerance in both types (both
    compute the state in fp32), y at the type's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(10)
    for (S, chunk, di, offset) in K4_EDGES:
        B = 2
        u, dts, Bt, Ct, A, D = _mamba_inputs(gen, dt, B, S, di)
        ku, kdt = ((_offset_leaf(t)[1].detach() for t in (u, dts)) if offset else (u, dts))
        y, h_init = mamba_scan.scan_fwd(ku, kdt, Bt, Ct, A, D, chunk)
        S_p = -(-S // chunk) * chunk
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, S_p - S))  # noqa: E731
        y_p, i_p = mamba_scan.fwd_plain(pad(u), pad(dts), pad(Bt), pad(Ct), A, D, chunk)
        assert h_init.shape == i_p.shape == (B, -(-S // chunk), di, 16)
        _assert_close([[h_init], [i_p]], torch.float32)
        _assert_close([[y], [y_p[:, :S]]], dt)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mamba_forward_states_do_not_depend_on_chunk(dtype):
    """K4's h_init at chunk 1, taken every 16th step, is its h_init at chunk
    16 bitwise, and y is the same at both: the state does not depend on the
    chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for (S, _, di, offset) in K4_EDGES:
        u, dts, Bt, Ct, A, D = _mamba_inputs(gen, dt, 2, S, di)
        if offset:
            u, dts = (_offset_leaf(t)[1].detach() for t in (u, dts))
        y1, h1 = mamba_scan.scan_fwd(u, dts, Bt, Ct, A, D, 1)
        y16, h16 = mamba_scan.scan_fwd(u, dts, Bt, Ct, A, D, 16)
        assert torch.equal(h1[:, ::16], h16)
        assert torch.equal(y1, y16)
