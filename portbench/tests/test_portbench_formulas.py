"""The frozen arithmetic against counts made by hand."""
import numpy as np
import pytest

import tiny  # noqa: F401
from portbench import formulas, kernels
from portbench.dims import Dims

M = Dims(layers=2, d=8, heads=4, kv_heads=2, head_dim=2, d_ff=16, vocab=10, eps=1e-5,
         rope_theta=1e4, compute_dtype="bfloat16", param_dtype="float32")


def test_kept_pairs_by_hand():
    row = [1, 1, 1, 2, 2, 0, 0, 0, 0]
    # segment 1: 3 tokens -> 1+2+3 = 6; segment 2: 2 -> 3; padding 4 -> 10
    assert formulas.kept_pairs(row, real_only=True) == 9
    assert formulas.kept_pairs(row, real_only=False) == 19


def test_matmul_params_by_hand():
    # per layer: wq 8*4*2 + wk, wv 2 * 8*2*2 + wo 4*2*8 = 64+64+64 = 192; ffn 3*8*16 = 384
    assert M.matmul_params == 2 * (192 + 384) + 8 * 10


def test_step_model_flops_by_hand():
    seg = np.array([[[1, 1, 1, 2, 2, 0, 0, 0, 0]], [[1] * 9]])
    tokens = 5 + 9
    pairs = 9 + 45
    want = 6.0 * (2 * 576 + 80) * tokens + 3 * 4 * 2 * 4 * 2 * pairs
    assert formulas.step_model_flops(M, seg) == pytest.approx(want, rel=1e-12)


def test_attention_bounds_by_hand():
    row = [1, 1, 1, 2, 2, 0, 0, 0, 0]
    S, pairs = 9, 19
    f = 4.0 * 2 * 4 * pairs
    qb, kvb, segb, rowb = 4 * S * 2 * 2, 2 * S * 2 * 2, S * 4, 4 * S * 4
    b = formulas.attention_launch_bounds(M, row)
    hbm, peak = formulas.HBM_BYTES_PER_S, formulas.PEAK_BF16_FLOPS
    assert b["K1"] == pytest.approx(max(f / peak, (2 * qb + 2 * kvb + segb + rowb) / hbm))
    assert b["K2"] == pytest.approx(max(1.5 * f / peak, (3 * qb + 2 * kvb + segb + 2 * rowb) / hbm))
    assert b["K3"] == pytest.approx(max(2 * f / peak, (2 * qb + 4 * kvb + segb + 2 * rowb) / hbm))


def test_busy_union_and_gaps():
    spans = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0), (-1.0, 0.5)]
    assert formulas.busy_union(spans, 0.0, 6.0) == pytest.approx(0.5 + 2.0 + 1.0)
    assert formulas.idle_gaps(spans, 0.0, 6.0) == [(0.5, 1.0), (3.0, 4.0), (5.0, 6.0)]


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::fwd_tc_kernel<128, false>(__nv_bfloat16 const*)", "K1"),
    ("void (anonymous namespace)::bwd_dq_tc_kernel<128, false>(x)", "K2"),
    ("void (anonymous namespace)::bwd_dkv_tc_kernel<128, false>(x)", "K3"),
    ("void fwd_kernel<128>(float const*)", "K1"),
    ("void fwd_kernel<__nv_bfloat16, 16, true>(x)", "K4"),
    ("void bwd_kernel<__nv_bfloat16, 16, true>(x)", "K5"),
    ("void wkv6_fwd_kernel<__nv_bfloat16, 64, true>(x)", "K6"),
    ("void wkv6_bwd_kernel<__nv_bfloat16, 64, true>(x)", "K7"),
    ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>(x)", None),
    ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", None),
])
def test_kernel_names(name, want):
    assert kernels.port_kernel(name) == want


def test_gemm_names():
    assert kernels.is_gemm("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT")
    assert kernels.is_gemm("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16>(x)")
    assert not kernels.is_gemm("void (anonymous namespace)::fwd_tc_kernel<128, false>(x)")
    assert not kernels.is_gemm("void at::native::vectorized_elementwise_kernel<4>(x)")
