"""RWKV-6 WKV recurrence: CUDA kernels K6 (forward) and K7 (backward), their
plain versions, and the autograd Function that wires them.

Counterpart of ``repro/kernels/rwkv6_scan.py`` (the Pallas TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``).  Same layout and semantics, per
(batch, head), with the state indexed [key dim i, value dim j]:

    S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ
    y_t = r_t·(S_{t-1} + diag(u)·k_t v_tᵀ)

r, k, v, w are ``(B, H, S, M)``, u is ``(H, M)``.  The forward emits y (in
r's dtype), the final state ``(B, H, M, M)`` f32 and the chunk-initial
states ``(B, H, n_chunks, M, M)`` f32; the backward replays each chunk from
its initial state and runs the adjoint ``G_{t-1} = diag(w_t)·G_t + r_t ŷ_tᵀ``
in reverse, seeded with the final state's cotangent (zeros when the caller
does not use the final state, as training does).  du comes back as a
per-batch partial ``(B, H, M)``, summed outside the kernel.

``wkv_fwd`` (K6) and ``wkv_bwd`` (K7) launch the kernels of
``csrc/rwkv6_scan.cu`` on CUDA tensors and count each launch in
``LAUNCHES``; ``fwd_plain`` and ``bwd_plain`` are their plain versions, the
same chunked algorithm as sequential torch loops.  The entry point
``rwkv6_scan_bhsm`` routes once: the kernels for a CUDA tensor, the plain
versions for a CPU tensor.

The chunk is internal (no output depends on it): ``CHUNK`` steps, which
keeps K7's replay history of ``chunk × M × M`` f32 in shared memory.  The plain
versions take inputs padded to a chunk multiple with the identity values of
``kernels/blocking.py``; the CUDA kernels load those values past the end.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.blocking import RWKV6_PAD_W, pad_axis, pick_block

CHUNK = 8

# Kernel launches since the last reset: kernel ("fwd" K6, "bwd" K7) -> count.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# --------------------------------------------------------------------------- #
# Plain versions (torch; S a multiple of chunk)
# --------------------------------------------------------------------------- #
def fwd_plain(r, k, v, w, u, chunk):
    """Plain K6: (y in r's dtype, s_final f32, s_init f32)."""
    B, H, S, M = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]                       # (1, H, M, 1)
    state = torch.zeros((B, H, M, M), dtype=torch.float32, device=r.device)
    ys, inits = [], []
    for t in range(S):
        if t % chunk == 0:
            inits.append(state)
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkm->bhm", rf[:, :, t], state + uf * kv))
        state = wf[:, :, t, :, None] * state + kv
    return torch.stack(ys, 2).to(r.dtype), state, torch.stack(inits, 2)


def bwd_plain(r, k, v, w, u, s_init, dy, ds, chunk):
    """Plain K7: (dr, dk, dv, dw) f32 ``(B, H, S, M)`` and the du partial
    f32 ``(B, H, M)``."""
    B, H, S, M = r.shape
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()[None]                                   # (1, H, M)
    g = ds.float().clone()                                 # dL/dS_t
    dr, dk, dv, dw = (torch.empty((B, H, S, M), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((B, H, M), dtype=torch.float32, device=r.device)
    for ic in reversed(range(S // chunk)):
        t0 = ic * chunk
        hist, state = [], s_init[:, :, ic].float()
        for t in range(t0, t0 + chunk):                    # replay pre-states
            hist.append(state)
            state = (wf[:, :, t, :, None] * state
                     + kf[:, :, t, :, None] * vf[:, :, t, None, :])
        for t in reversed(range(t0, t0 + chunk)):
            s_prev = hist[t - t0]
            r_t, k_t, v_t, w_t, dy_t = (x[:, :, t] for x in (rf, kf, vf, wf, dyf))
            vdy = torch.sum(v_t * dy_t, -1, keepdim=True)  # ⟨v_t, ŷ_t⟩
            dw[:, :, t] = torch.sum(g * s_prev, -1)
            dk[:, :, t] = torch.sum(g * v_t[:, :, None], -1) + uf * r_t * vdy
            dv[:, :, t] = (torch.sum(g * k_t[..., None], -2)
                           + torch.sum(r_t * uf * k_t, -1, keepdim=True) * dy_t)
            dr[:, :, t] = torch.sum(s_prev * dy_t[:, :, None], -1) + uf * k_t * vdy
            du = du + r_t * k_t * vdy
            g = w_t[..., None] * g + r_t[..., None] * dy_t[:, :, None]
    return dr, dk, dv, dw, du


# --------------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------------- #
def _check(r, k, v, w, u, chunk, extra=()):
    """Raise on what the CUDA kernels do not take."""
    B, H, S, M = r.shape
    if M not in (32, 64):
        raise ValueError(f"CUDA WKV6 takes head size 32 or 64, got {M}")
    if r.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"CUDA WKV6 takes bf16 or fp32 r/k/v, got {r.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("r, k and v must share one dtype")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"CUDA WKV6 takes f32 w and u, got {w.dtype} and {u.dtype}")
    if any(t.shape != r.shape for t in (k, v, w)) or u.shape != (H, M):
        raise ValueError(f"shapes r/k/v/w {tuple(r.shape)} and u {tuple(u.shape)} "
                         "must be (B, H, S, M) and (H, M)")
    smem = 4 * (chunk * M * (M + 4) + 5 * chunk * M + 2 * chunk + M)
    if chunk < 1 or smem > build.SMEM_PER_BLOCK:
        raise ValueError(f"chunk {chunk} needs {smem} B of shared memory")
    for t in (r, k, v, w, u, *extra):
        if t.device != r.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous on r's CUDA device")


def _dims(r, chunk):
    B, H, S, M = r.shape
    return (B, H, S, M, chunk, int(r.dtype == torch.bfloat16),
            torch.cuda.current_stream(r.device).cuda_stream)


def wkv_fwd(r, k, v, w, u, chunk):
    """K6 → (y, s_final, s_init)."""
    _check(r, k, v, w, u, chunk)
    B, H, S, M = r.shape
    lib = build.load("rwkv6_scan")
    y = torch.empty_like(r)
    s_final = torch.empty((B, H, M, M), dtype=torch.float32, device=r.device)
    s_init = torch.empty((B, H, -(-S // chunk), M, M), dtype=torch.float32,
                         device=r.device)
    build.call(lib.wkv6_fwd, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), y.data_ptr(), s_final.data_ptr(), s_init.data_ptr(),
               *_dims(r, chunk))
    LAUNCHES["fwd"] += 1
    return y, s_final, s_init


def wkv_bwd(r, k, v, w, u, s_init, dy, ds, chunk):
    """K7 → (dr, dk, dv, dw, du partial)."""
    B, H, S, M = r.shape
    _check(r, k, v, w, u, chunk, (s_init, dy, ds))
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise ValueError("dy must match r's shape and dtype")
    if ds.shape != (B, H, M, M) or s_init.shape != (B, H, -(-S // chunk), M, M) \
            or ds.dtype != torch.float32 or s_init.dtype != torch.float32:
        raise ValueError("ds and s_init must be f32 (B, H, M, M) and "
                         "(B, H, n_chunks, M, M)")
    lib = build.load("rwkv6_scan")
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.empty((B, H, M), dtype=torch.float32, device=r.device)
    build.call(lib.wkv6_bwd, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
               u.data_ptr(), s_init.data_ptr(), dy.data_ptr(), ds.data_ptr(),
               dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
               du.data_ptr(), *_dims(r, chunk))
    LAUNCHES["bwd"] += 1
    return dr, dk, dv, dw, du


class _Scan(torch.autograd.Function):
    """K6 forward, K7 backward (the reference's ``custom_vjp``).  ``plain``
    selects the plain versions whatever the device."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk, plain):
        fwd = fwd_plain if plain else wkv_fwd
        y, s_final, s_init = fwd(r, k, v, w, u, chunk)
        ctx.save_for_backward(r, k, v, w, u, s_init)
        ctx.chunk, ctx.plain = chunk, plain
        ctx.set_materialize_grads(False)
        return y, s_final

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u, s_init = ctx.saved_tensors
        B, H, S, M = r.shape
        # an unused output (training never reads the final state) has no
        # cotangent: it contributes zeros
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        ds = (torch.zeros((B, H, M, M), dtype=torch.float32, device=r.device)
              if ds is None else ds.float().contiguous())
        bwd = bwd_plain if ctx.plain else wkv_bwd
        dr, dk, dv, dw, du = bwd(r, k, v, w, u, s_init, dy, ds, ctx.chunk)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
                du.sum(0).to(u.dtype), None, None)


def rwkv6_scan_bhsm(r, k, v, w, u, *, chunk: int = CHUNK, plain: bool = False):
    """r, k, v, w: (B, H, S, M); u: (H, M).  Returns y (B, H, S, M) in r's
    dtype and the final state (B, H, M, M) f32.  Differentiable in every
    input.

    The plain versions run on inputs padded to a chunk multiple (w = 1,
    r = k = v = 0: the state passes through, so the final state is exact);
    pad and slice stay outside the autograd Function, as the reference
    keeps them outside ``custom_vjp``.  The CUDA kernels take the inputs as
    they are."""
    S = r.shape[2]
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    plain = plain or build.route(r, "WKV6") == "plain"
    if plain:
        c, S_p = pick_block(S, chunk)
        r, k, v = (pad_axis(t, S_p, axis=2) for t in (r, k, v))
        w = pad_axis(w, S_p, axis=2, value=RWKV6_PAD_W)
    else:
        c = min(chunk, S)
    y, s_final = _Scan.apply(r, k, v, w, u, c, plain)
    return y[:, :, :S], s_final
