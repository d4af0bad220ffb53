"""Microbenchmark harness for the kernels (the reference's
``kernels/bench.py``), and the work counts the bounds use.

Closes the predict↔measure loop at the kernel layer: every plan/schedule/
composition decision is priced from the analytic tables in
``core.profiling`` (HardwareSpec peak FLOPs × utilization).  ``bench_kernel``
times forward and forward+backward executions of the three kernel families
through the port's entry points across the profiler's pow2 shape buckets
(the same ``runtime.calibration.shape_bucket`` keys the scheduler corrects
with), prices the identical shapes analytically (the H100 spec unless
``hw`` is given), and ``seed_calibrator`` feeds the measured ratios into
``OnlineCalibrator`` cells.  On the card the cases launch the CUDA kernels
(attention K1, then K1+K2+K3; the Mamba scan K4, then K4+K5; RWKV6 K6, then
K6+K7) in fp32, as the reference's cases run in f32; on the CPU the plain
versions.

``normalize`` folds out one scalar *unit* per (kernel, direction), the
geomean of measured/analytic, so the per-bucket ``ratio`` validates
shape-scaling fidelity (does doubling the sequence double the time the way
the FLOP model says?), which is the property the planner's relative
decisions depend on.  The unit itself is what a calibrator cell learns.

The rest of the module counts work for the kernels' bounds: operations
(the reference's counts, and what the WKV recurrence itself needs) and the
bytes each scan kernel must move.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.common.types import resolve_device
from repro_torch.core.profiling.analytic import H100, HardwareSpec
from repro_torch.core.profiling.flops import TRAIN_MULT
from repro_torch.kernels import ops
from repro_torch.runtime.calibration import OnlineCalibrator, shape_bucket


def attention_flops(B: int, H: int, S: int, D: int, *, causal: bool) -> float:
    """score + AV matmuls: 2·2·B·S·S·H·D, halved under causal masking."""
    f = 4.0 * B * S * S * H * D
    return f * 0.5 if causal else f


def mamba_flops(B: int, S: int, di: int, N: int) -> float:
    """Selective-scan term of ``flops._mamba_layer``: 6·B·S·di·N."""
    return 6.0 * B * S * di * N


def rwkv6_flops(B: int, H: int, S: int, M: int) -> float:
    """WKV recurrence term of ``flops._rwkv_layer`` with d = H·M:
    6·B·S·(H·M)·M."""
    return 6.0 * B * S * H * M * M


# The operations the WKV recurrence needs, per state element (i, j) and step
# (an FMA counts 2); the u-term and the dot products over v are O(M) per step.
# The reference's 6 per element (``rwkv6_flops``) is a profiler's estimate and
# over-counts the forward.
def rwkv6_fwd_ops(B: int, H: int, S: int, M: int) -> float:
    """K6: k_i·v_j (1), S_ij ← w_i·S_ij + kv_ij (2), y_j += r_i·S_ij (2)."""
    return 5.0 * B * H * S * M * M


def rwkv6_bwd_ops(B: int, H: int, S: int, M: int) -> float:
    """K7: the adjoint G_ij ← w_i·G_ij + r_i·ŷ_j (3) and the four contractions
    dw_i = Σ_j G_ij·S_ij, dk_i = Σ_j G_ij·v_j, dr_i = Σ_j S_ij·ŷ_j,
    dv_j = Σ_i G_ij·k_i (2 each).  Replaying the states from the
    chunk-initial ones is the kernel's own cost, not the function's."""
    return 11.0 * B * H * S * M * M


# Bytes each scan kernel must move: every input read once, every output
# written once.  ``e`` is the byte size of the sequence type (2 for bf16,
# 4 for f32); parameters, states and gradients are f32.  Only the function's
# own inputs and outputs count: the chunk-initial states the forward saves
# for the backward are a residual whose size the chunk sets, and cross-block
# partials are counted at their reduced size.
def mamba_fwd_bytes(B: int, S: int, di: int, N: int, e: int) -> float:
    """K4: u, dt, B_t, C_t, A, D in; y out."""
    return e * (3 * B * S * di + 2 * B * S * N) + 4 * (di * N + di)


def mamba_fwd_h_init_bytes(B: int, S: int, di: int, N: int, chunk: int) -> float:
    """K4's residual: the fp32 chunk-initial states (B, ceil(S / chunk), di, N)
    it writes for K5, beyond ``mamba_fwd_bytes``."""
    return 4.0 * B * -(-S // chunk) * di * N


def mamba_fwd_exps(B: int, S: int, di: int, N: int) -> float:
    """K4's exponentials: one decay exp(dt·a) a state element and step."""
    return float(B * S * di * N)


def mamba_bwd_bytes(B: int, S: int, di: int, N: int, e: int) -> float:
    """K5: u, dt, B_t, C_t, A, D, dy in; du, ddt, dB, dC, dA, dD (f32) out."""
    return (e * (3 * B * S * di + 2 * B * S * N) + 4 * (di * N + di)
            + 4 * (2 * B * S * di + 2 * B * S * N + di * N + di))


def rwkv6_fwd_bytes(B: int, H: int, S: int, M: int, e: int) -> float:
    """K6: r, k, v (e), w, u (f32) in; y (e), final state (f32) out."""
    return e * 4 * B * H * S * M + 4 * (B * H * S * M + H * M + B * H * M * M)


def rwkv6_bwd_bytes(B: int, H: int, S: int, M: int, e: int) -> float:
    """K7: r, k, v, dy (e), w, u, ds (f32) in; dr, dk, dv, dw, du (f32) out."""
    return (e * 4 * B * H * S * M + 4 * (B * H * S * M + H * M + B * H * M * M)
            + 4 * (4 * B * H * S * M + H * M))


def analytic_seconds(flops: float, hw: HardwareSpec = H100) -> float:
    """The tables' price for ``flops`` of kernel work on one chip."""
    return flops / (hw.peak_flops * hw.base_mxu_util)


# ---------------------------------------------------------------------- #
# Timing
# ---------------------------------------------------------------------- #
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, *args, iters: int, warmup: int = 1) -> List[float]:
    """Per-iteration wall times (s), after ``warmup`` calls; each call is
    bracketed by a device synchronize (on a CUDA input)."""
    device = args[0].device
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        out.append(time.perf_counter() - t0)
    return out


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device=gen.device)


def _case_attention(S: int, *, B: int, KH: int, G: int, D: int, causal: bool,
                    device):
    gen = torch.Generator(device=device).manual_seed(S)
    H = KH * G
    q = _randn(gen, B, S, H, D)
    k = _randn(gen, B, S, KH, D)
    v = _randn(gen, B, S, KH, D)
    seg = torch.ones((B, S), dtype=torch.int32, device=device)

    def fwd(q, k, v):
        return ops.packed_flash_attention(q, k, v, segment_ids=seg,
                                          causal=causal)

    return fwd, (q, k, v), attention_flops(B, H, S, D, causal=causal)


def _case_mamba(S: int, *, B: int, di: int, N: int, device):
    gen = torch.Generator(device=device).manual_seed(S + 1)
    u = _randn(gen, B, S, di)
    dt = F.softplus(_randn(gen, B, S, di) - 1.0)
    B_t = _randn(gen, B, S, N)
    C_t = _randn(gen, B, S, N)
    A = -torch.exp(_randn(gen, di, N) * 0.5)
    D = _randn(gen, di)

    def fwd(u, dt, B_t, C_t, A, D):
        y, _ = ops.mamba_scan(u, dt, B_t, C_t, A, D)
        return y

    return fwd, (u, dt, B_t, C_t, A, D), mamba_flops(B, S, di, N)


def _case_rwkv6(S: int, *, B: int, H: int, M: int, device):
    gen = torch.Generator(device=device).manual_seed(S + 2)
    r = _randn(gen, B, S, H, M)
    k = _randn(gen, B, S, H, M)
    v = _randn(gen, B, S, H, M)
    w = torch.exp(-torch.exp(_randn(gen, B, S, H, M) * 0.5))
    u = _randn(gen, H, M)

    def fwd(r, k, v, w):
        y, _ = ops.rwkv6_scan(r, k, v, w, u)
        return y

    return fwd, (r, k, v, w), rwkv6_flops(B, H, S, M)


_CASES = {"attention": _case_attention, "mamba": _case_mamba,
          "rwkv6": _case_rwkv6}

# bench defaults: the reference's modest model dims; the swept axis is the
# sequence length (the profiler's bucketed shape)
DEFAULT_DIMS: Dict[str, dict] = {
    "attention": dict(B=1, KH=2, G=2, D=64, causal=True),
    "mamba": dict(B=1, di=128, N=16),
    "rwkv6": dict(B=1, H=2, M=32),
}


def bench_kernel(kernel: str, seqs: Sequence[int], *, iters: int = 3,
                 hw: HardwareSpec = H100, dims: Optional[dict] = None,
                 device="cuda") -> List[dict]:
    """Time fwd and fwd+bwd across ``seqs``; one row per (S, direction).

    Rows carry the raw per-iteration times (``times_s``) so a calibrator
    can be seeded with every observation, plus the analytic price of the
    same shape (bwd priced at ``TRAIN_MULT − 1`` × fwd, the standard
    backward ≈ 2× forward count the tables use)."""
    dev = resolve_device(device)
    case = _CASES[kernel]
    dims = dict(DEFAULT_DIMS[kernel], **(dims or {}))
    rows = []
    for S in seqs:
        fwd, args, f_fwd = case(int(S), **dims, device=dev)

        def fwdbwd(*a):
            a = [x.detach().requires_grad_(True) for x in a]
            loss = torch.sum(fwd(*a))
            return loss.detach(), torch.autograd.grad(loss, a)

        for direction, fn, flops in (
                ("fwd", fwd, f_fwd),
                ("fwdbwd", fwdbwd, f_fwd * TRAIN_MULT)):
            times = _time_fn(fn, *args, iters=iters)
            rows.append({
                "kernel": kernel,
                "direction": direction,
                "tokens": int(S),
                "bucket": shape_bucket(float(S)),
                "flops": flops,
                "analytic_s": analytic_seconds(flops, hw),
                "times_s": times,
                "measured_s": float(sorted(times)[len(times) // 2]),
            })
    return rows


def normalize(rows: List[dict]) -> List[dict]:
    """Add the host unit (per-(kernel, direction) geomean measured/analytic)
    and the unit-normalized ``ratio`` to every row, in place."""
    groups: Dict[tuple, List[dict]] = {}
    for r in rows:
        groups.setdefault((r["kernel"], r["direction"]), []).append(r)
    for grp in groups.values():
        logs = [math.log(r["measured_s"] / r["analytic_s"]) for r in grp
                if r["measured_s"] > 0 and r["analytic_s"] > 0]
        unit = math.exp(sum(logs) / len(logs)) if logs else float("nan")
        for r in grp:
            r["unit"] = unit
            denom = unit * r["analytic_s"]
            r["ratio"] = r["measured_s"] / denom if denom > 0 else float("nan")
    return rows


def seed_calibrator(cal: OnlineCalibrator, rows: List[dict], *,
                    module: str = "llm", tp: int = 1) -> int:
    """Feed every benchmarked iteration into calibrator cells keyed exactly
    like the scheduler's observations ((module, shape_bucket(tokens), tp);
    the online scheduler names its decoder module "llm").  The *predicted*
    side is the unit-normalized analytic price, so the learned cell ratio
    is the same shape-residual the ratio rows report.  Returns the number
    of observations fed; with ``iters ≥ 2`` each touched cell matures past
    ``min_obs`` immediately."""
    n = 0
    for r in rows:
        pred = r.get("unit", float("nan")) * r["analytic_s"]
        if not (pred > 0):
            continue
        for t in r["times_s"]:
            cal.observe(module, float(r["tokens"]), tp, pred, t)
            n += 1
    return n
