"""The CUDA kernels K1–K3 against their plain versions, on the card.

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

from repro_torch.kernels import packed_flash_attention as pfa


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dt = getattr(torch, dtype)
    t_max, t_rel = (1e-4, 1e-5) if dt == torch.float32 else (2e-2, 1e-2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (B, KH, G, S, D, causal, window) in [(1, 2, 2, 131, 64, True, 0),
                                             (2, 2, 1, 96, 128, False, 0),
                                             (1, 1, 4, 200, 64, True, 37)]:
        q = torch.randn(B, KH, G, S, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, KH, S, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, KH, S, D, generator=gen, device="cuda").to(dt)
        seg = torch.zeros(B, S, dtype=torch.int32, device="cuda")
        seg[:, S // 3:] = 1
        outs = []
        for plain in (False, True):
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            y = pfa.packed_flash_attention_bkgsd(
                qs, ks, vs, seg, seg, causal=causal, window=window,
                block_q=64, block_k=64, plain=plain)
            grads = torch.autograd.grad(torch.sin(y.float()).sum(), (qs, ks, vs))
            outs.append([y, *grads])
        for a, b in zip(*outs):
            d, b = a.float() - b.float(), b.float()
            assert d.abs().max().item() <= t_max * b.abs().max().item()
            assert d.norm().item() <= t_rel * b.norm().item()
