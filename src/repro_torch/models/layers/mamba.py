"""Mamba-1 selective-state-space block (Jamba's SSM half), the train
branch of the reference layer (no decode cache).

Recurrence (per channel c, state dim n):
    h_t = exp(dt_t * A) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

Implementations of the scan, chosen by ``impl``:

  * ``naive``  — ``ssm_scan_xla``, a Python loop over time that autograd
                 differentiates (the reference's XLA scan);
  * ``kernel`` — the selective-scan kernels K4/K5 (``kernels/mamba_scan.py``):
                 CUDA on a CUDA tensor, their plain versions on a CPU tensor.

The causal convolution and the scan run across packed segment boundaries,
as in the reference (``segment_ids`` is not read).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops as kops

IMPLS = ("naive", "kernel")


def dims(cfg: ModelConfig):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.ssm_d_state, cfg.ssm_d_conv


def init(gen, cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    di, R, N, K = dims(cfg)
    dev = gen.device

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=dev) * s).to(dtype)

    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).expand(di, N)
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((di, K), K ** -0.5),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": normal((di, R + 2 * N), di ** -0.5),
        "dt_proj": normal((R, di), R ** -0.5),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(A).to(dtype),
        "D": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal((di, d), di ** -0.5),
    }


def causal_conv(x, conv_w, conv_b):
    """x: (B, S, di) depthwise causal conv along S."""
    B, S, di = x.shape
    K = conv_w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    # stack K shifted views: y_t = sum_k w[:,k] * x_{t-K+1+k}
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + S].float() * conv_w[:, k].float()
    return (y + conv_b.float()).to(x.dtype)


def ssm_scan_xla(u, dt, B_t, C_t, A, D):
    """Sequential selective scan (the naive path).

    u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,)
    Returns y: (B, S, di) in u's dtype and the final state (B, di, N) f32."""
    b, S, di = u.shape
    N = A.shape[1]
    uf, dtf, bf, cf = (t.float() for t in (u, dt, B_t, C_t))
    h = torch.zeros((b, di, N), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t, :, None] * A[None])
        h = h * decay + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, cf[:, t]))
    y = torch.stack(ys, 1) + uf * D.float()[None, None]
    return y.to(u.dtype), h


def _project(params, x, cfg: ModelConfig):
    di = dims(cfg)[0]
    xz = x @ params["in_proj"].to(x.dtype)
    return xz[..., :di], xz[..., di:]      # u, z


def _bcdt(params, u, cfg: ModelConfig):
    di, R, N, K = dims(cfg)
    proj = u @ params["x_proj"].to(u.dtype)
    dt_low, B_t, C_t = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    dt = F.softplus(dt_low @ params["dt_proj"].to(u.dtype)
                    + params["dt_bias"].to(u.dtype))
    return dt, B_t, C_t


def apply(params, x, cfg: ModelConfig, *, impl: str = "kernel"):
    """x: (B, S, d) -> (B, S, d), training / prefill without a cache."""
    A = -torch.exp(params["A_log"].float())
    D = params["D"]
    u, z = _project(params, x, cfg)
    u = F.silu(causal_conv(u, params["conv_w"], params["conv_b"]))
    dt, B_t, C_t = _bcdt(params, u, cfg)
    if impl == "kernel":
        y, _ = kops.mamba_scan(u, dt, B_t, C_t, A, D)
    elif impl == "naive":
        y, _ = ssm_scan_xla(u, dt, B_t, C_t, A, D)
    else:
        raise ValueError(f"selective-scan impl {impl!r} not in {IMPLS}")
    y = y * F.silu(z)
    return y @ params["out_proj"].to(x.dtype)
