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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rwkv6_scan_matches_plain(dtype):
    """K6 forward and K7 gradients, with and without a final-state
    cotangent; prime lengths span several chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for (B, H, S, M, final_cot) in [(2, 3, 131, 64, True), (1, 2, 61, 32, True),
                                    (2, 2, 40, 64, False)]:
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        ins = [rnd(B, H, S, M).to(dt), rnd(B, H, S, M).to(dt), rnd(B, H, S, M).to(dt),
               torch.sigmoid(rnd(B, H, S, M)), rnd(H, M) * 0.1]
        cy, cs = rnd(B, H, S, M), rnd(B, H, M, M) if final_cot else None
        outs = []
        for plain in (False, True):
            ts = [t.clone().requires_grad_(True) for t in ins]
            y, s = rwkv6_scan.rwkv6_scan_bhsm(*ts, plain=plain)
            loss = (y.float() * cy).sum() + ((s * cs).sum() if final_cot else 0)
            outs.append([y, s, *torch.autograd.grad(loss, ts)])
        _assert_close(outs, dt)


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
