"""The port's op-level statistics (``repro_torch.launch.hlo_stats``) against
the numbers the reference's HLO analyzer tests hold (tests/test_hlo_stats.py),
plus what only the port's recorder does: collectives on a fake process
group, a DTensor product counted at one rank's share, and the kernels'
custom ops (K1–K7) checked by ``torch.library.opcheck``.

The fake process group (256 ranks, this process rank 0) is started for this
module and destroyed after it."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.hlo_stats import Recorder, analyze, muted_propagation, shape_bytes
from repro_torch.kernels import mamba_scan, packed_flash_attention as pfa, rwkv6_scan


@pytest.fixture(scope="module")
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_shape_bytes():
    # the reference's f32[4,8], bf16[10], (s32[], f32[2,2]) and pred[7]
    assert shape_bytes((4, 8), torch.float32) == 128
    assert shape_bytes((10,), torch.bfloat16) == 20
    assert shape_bytes((), torch.int32) + shape_bytes((2, 2), torch.float32) == 4 + 16
    assert shape_bytes((7,), torch.bool) == 7


def test_dot_flops_simple():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    np.testing.assert_allclose(analyze(lambda: a @ b).flops, 2 * 64 * 128 * 32)


def test_loop_trips_multiply_flops():
    """Eager loops run every trip: the count needs no trip-count correction,
    and the caller records the loop under ``while_trips``."""
    x = torch.randn(32, 32)
    rec = Recorder()
    rec.note_loop("scan", 12)
    with muted_propagation(), rec:
        c = x
        for _ in range(12):
            c = c @ c
    np.testing.assert_allclose(rec.stats.flops, 12 * 2 * 32 ** 3)
    assert 12 in rec.stats.while_trips.values()


def test_nested_loops_multiply():
    x = torch.randn(16, 16)

    def f():
        c = x
        for _ in range(4):
            for _ in range(3):
                c = c @ c
        return c

    np.testing.assert_allclose(analyze(f).flops, 12 * 2 * 16 ** 3)


def test_hbm_bytes_positive_and_scaled():
    x = torch.randn(256, 256)
    assert analyze(lambda: x + 1).hbm_bytes >= 2 * 256 * 256 * 4   # read + write


def test_all_reduce_on_fake_group_counted_once(fake_group):
    """A c10d all-reduce on a fake group of 8 moves nothing; the recorder
    reads its operand: one all-reduce of 1000 fp32 elements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    group = dist.new_group(list(range(8)))
    with FakeTensorMode():
        t = torch.randn(1000)
        st = analyze(lambda: dist.all_reduce(t, group=group))
    assert dict(st.collective_counts) == {"all-reduce": 1}
    assert dict(st.collective_bytes) == {"all-reduce": 4000.0}


def test_dtensor_product_counts_local_share(fake_group):
    """(256, 4096, 1024) rows over 16 data ranks times (1024, 4096) columns
    over 16 model ranks: rank 0 multiplies (16, 4096, 1024) by (1024, 256),
    1/256 of the global product's FLOPs, and no collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = DTensor.from_local(torch.randn(16, 4096, 1024), mesh, [Shard(0), Replicate()])
        w = DTensor.from_local(torch.randn(1024, 256), mesh, [Replicate(), Shard(1)])
        st = analyze(lambda: x @ w)
    glob = 2.0 * 256 * 4096 * 1024 * 4096
    assert st.flops == glob / 256
    assert st.total_collective_bytes == 0


def _small_cases():
    g = torch.Generator().manual_seed(0)
    n = lambda *s: torch.randn(*s, generator=g)             # noqa: E731
    B, KH, G, S, D = 1, 2, 2, 8, 8
    q, k, v = n(B, KH, G, S, D), n(B, KH, S, D), n(B, KH, S, D)
    seg = torch.zeros(B, S, dtype=torch.int32)
    o, lse = pfa.fwd_plain(q, k, v, seg, seg, True, 0, S, S)
    dout = n(*q.shape)
    delta = (dout * o).sum(-1)
    bwd = (q, k, v, seg, seg, dout, lse, delta, True, 0, S, S)
    di, N, c = 4, 16, 4
    u, dt = n(1, S, di), n(1, S, di).abs() * 0.1
    Bt, Ct, A, Dd = n(1, S, N), n(1, S, N), -n(di, N).abs(), n(di)
    y, h0 = mamba_scan.fwd_plain(u, dt, Bt, Ct, A, Dd, c)
    H, M = 2, 8
    r, kk, vv = n(1, H, S, M), n(1, H, S, M), n(1, H, S, M)
    w, uu = torch.sigmoid(n(1, H, S, M)), n(H, M)
    _, _, s0 = rwkv6_scan.fwd_plain(r, kk, vv, w, uu, c)
    ds = n(1, H, M, M)
    ops = torch.ops.repro_torch
    yield ops.mamba_fwd, (u, dt, Bt, Ct, A, Dd, c, True)
    yield ops.mamba_bwd, (u, dt, Bt, Ct, A, Dd, h0, n(*y.shape), c, True)
    yield ops.rwkv6_fwd, (r, kk, vv, w, uu, c, True)
    yield ops.rwkv6_bwd, (r, kk, vv, w, uu, s0, n(1, H, S, M), ds, c, True)
    for plain in (True, False):
        yield ops.pfa_fwd, (q, k, v, seg, seg, True, 0, S, S, plain)
        yield ops.pfa_bwd_dq, (*bwd, plain)
        yield ops.pfa_bwd_dkv, (*bwd, plain)


@pytest.mark.parametrize("case", range(10))
def test_kernel_custom_ops_opcheck(case):
    """Each kernel op on the CPU route against its fake implementation and
    schema: ``plain`` set (the scans' ``plain`` False is the CUDA launch
    itself), and for K1–K3 also unset (their wrappers route a CPU tensor to
    the plain version)."""
    op, args = list(_small_cases())[case]
    torch.library.opcheck(op, args, test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))


def test_kernel_ops_count_their_formulas():
    """The recorder counts each kernel op by the formula its module
    registers (K1 at a dense mask: 4·D·H·B·Sq·Sk, K2 1.5x, K3 2x; K4
    6·B·S·di·N, K5 2x; K6 5·B·H·S·M², K7 11x that over 5)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    want = {"pfa_fwd": 4.0 * 8 * 4 * 1 * 8 * 8, "mamba_fwd": 6.0 * 1 * 8 * 4 * 16,
            "rwkv6_fwd": 5.0 * 1 * 2 * 8 * 8 * 8}
    want.update(pfa_bwd_dq=1.5 * want["pfa_fwd"], pfa_bwd_dkv=2 * want["pfa_fwd"],
                mamba_bwd=2 * want["mamba_fwd"], rwkv6_bwd=11 / 5 * want["rwkv6_fwd"])
    cases = list(_small_cases())[:7]
    with FakeTensorMode(allow_non_fake_inputs=True):
        for op, args in cases:
            st = analyze(lambda: op(*args))
            assert st.flops == want[str(op).split(".")[1]], op
