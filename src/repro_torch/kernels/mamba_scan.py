"""Mamba-1 selective scan: CUDA kernels K4 (forward) and K5 (backward),
their plain versions, and the autograd Function that wires them.

Counterpart of ``repro/kernels/mamba_scan.py`` (the Pallas TPU kernels
``_fwd_kernel`` and ``_bwd_kernel``).  Same layout and semantics, per batch
row and channel c with an N-wide state:

    h_t = exp(dt_t ⊗ A) ⊙ h_{t-1} + (dt_t u_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ u_t

u, dt are ``(B, S, di)``, B_t, C_t ``(B, S, N)``, A ``(di, N)``, D ``(di,)``.
The forward emits y (in u's dtype) and the chunk-initial states
``(B, n_chunks, di, N)`` f32; the backward replays each chunk from its
initial state and runs the adjoint ``g_t = G_t + ŷ_t ⊗ C_t``,
``G_{t-1} = g_t ⊙ decay_t`` in reverse.  Sums across channels and batch rows
come back as partials, summed outside the kernel as in the reference: dB and
dC ``(n_cblk, B, S, N)`` over channel blocks, dA ``(B, di, N)`` and dD
``(B, di)`` over batch rows.

``scan_fwd`` (K4) and ``scan_bwd`` (K5) launch the kernels of
``csrc/mamba_scan.cu`` on CUDA tensors and count each launch in
``LAUNCHES``; ``fwd_plain`` and ``bwd_plain`` are their plain versions, the
same chunked algorithm as sequential torch loops.  The entry point
``mamba_scan_bsd`` routes once: the kernels for a CUDA tensor, the plain
versions for a CPU tensor.

The chunk is internal (no output depends on it): ``CHUNK`` steps.  K5 keeps
a chunk's replay history in registers, unrolled over ``K5_CHUNK`` steps, so
it takes chunks of at most that many.  The plain versions take inputs padded
to a chunk multiple (dt = 0: a padded step is the identity); the CUDA kernels
load that value past the end.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.blocking import MAMBA_PAD_DT, pad_axis, pick_block

CHUNK = 16
K5_CHUNK = 16        # the longest chunk K5 takes (K5_CH in the .cu)
C_BLK = 128          # channels per CUDA block (CB in the .cu)
D_STATE = 16         # the state width the CUDA kernels take

# Kernel launches since the last reset: kernel ("fwd" K4, "bwd" K5) -> count.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# --------------------------------------------------------------------------- #
# Plain versions (torch; S a multiple of chunk)
# --------------------------------------------------------------------------- #
def fwd_plain(u, dt, B_t, C_t, A, D, chunk):
    """Plain K4: (y in u's dtype, h_init f32 (B, n_chunks, di, N))."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    uf, dtf, bf, cf = (t.float() for t in (u, dt, B_t, C_t))
    Af, Df = A.float(), D.float()
    h = torch.zeros((Bsz, di, N), dtype=torch.float32, device=u.device)
    ys, inits = [], []
    for t in range(S):
        if t % chunk == 0:
            inits.append(h)
        decay = torch.exp(dtf[:, t, :, None] * Af)
        h = h * decay + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], -1) + Df * uf[:, t])
    return torch.stack(ys, 1).to(u.dtype), torch.stack(inits, 1)


def bwd_plain(u, dt, B_t, C_t, A, D, h_init, dy, chunk):
    """Plain K5: du, ddt f32 (B, S, di); dB, dC partials f32
    (n_cblk, B, S, N) over blocks of C_BLK channels; dA partial f32
    (B, di, N); dD partial f32 (B, di)."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    n_cblk = -(-di // C_BLK)
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, B_t, C_t, dy))
    Af, Df = A.float(), D.float()
    g = torch.zeros((Bsz, di, N), dtype=torch.float32, device=u.device)
    du, ddt = (torch.empty((Bsz, S, di), dtype=torch.float32, device=u.device)
               for _ in range(2))
    dB, dC = (torch.empty((n_cblk, Bsz, S, N), dtype=torch.float32,
                          device=u.device) for _ in range(2))
    dA = torch.zeros((Bsz, di, N), dtype=torch.float32, device=u.device)
    dD = torch.zeros((Bsz, di), dtype=torch.float32, device=u.device)

    def blocks(x):                      # (B, di, N) -> (n_cblk, B, N) sums
        x = F.pad(x, (0, 0, 0, n_cblk * C_BLK - di))
        return x.reshape(Bsz, n_cblk, C_BLK, N).sum(2).transpose(0, 1)

    for ic in reversed(range(S // chunk)):
        t0 = ic * chunk
        hist, h = [], h_init[:, ic].float()
        for t in range(t0, t0 + chunk):                    # replay pre-states
            hist.append(h)
            h = (h * torch.exp(dtf[:, t, :, None] * Af)
                 + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :])
        for t in reversed(range(t0, t0 + chunk)):
            h_prev = hist[t - t0]
            u_t, dt_t, dy_t = uf[:, t], dtf[:, t], dyf[:, t]      # (B, di)
            b_t, c_t = bf[:, t, None, :], cf[:, t, None, :]       # (B, 1, N)
            decay = torch.exp(dt_t[..., None] * Af)
            x_t = dt_t * u_t
            h_t = h_prev * decay + x_t[..., None] * b_t
            gt = g + dy_t[..., None] * c_t                        # dL/dh_t
            dC[:, :, t] = blocks(dy_t[..., None] * h_t)
            dB[:, :, t] = blocks(gt * x_t[..., None])
            gh = gt * h_prev * decay
            dx = torch.sum(gt * b_t, -1)
            ddt[:, t] = dx * u_t + torch.sum(gh * Af, -1)
            du[:, t] = dx * dt_t + Df * dy_t
            dA = dA + gh * dt_t[..., None]
            dD = dD + dy_t * u_t
            g = gt * decay
    return du, ddt, dB, dC, dA, dD


# --------------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------------- #
def _check(u, dt, B_t, C_t, A, D, chunk, extra=(), bwd=False):
    """Raise on what the CUDA kernels do not take (``bwd``: K5's, else
    K4's)."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    if N != D_STATE:
        raise ValueError(f"CUDA selective scan takes state width {D_STATE}, got {N}")
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"CUDA selective scan takes bf16 or fp32 u, got {u.dtype}")
    if any(t.dtype != u.dtype for t in (dt, B_t, C_t)):
        raise ValueError("u, dt, B_t and C_t must share one dtype")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise ValueError(f"CUDA selective scan takes f32 A and D, got {A.dtype} "
                         f"and {D.dtype}")
    if dt.shape != u.shape or B_t.shape != (Bsz, S, N) or C_t.shape != (Bsz, S, N) \
            or A.shape != (di, N) or D.shape != (di,):
        raise ValueError("shapes must be u, dt (B, S, di); B_t, C_t (B, S, N); "
                         "A (di, N); D (di,)")
    if chunk < 1 or (bwd and chunk > K5_CHUNK):
        raise ValueError(f"chunk {chunk}: K4 takes any of 1 step or more, K5 1 to "
                         f"{K5_CHUNK} (the replay history it holds in registers)")
    if Bsz > 65535:
        raise ValueError("batch exceeds the grid's y limit")
    for t in (u, dt, B_t, C_t, A, D, *extra):
        if t.device != u.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous on u's CUDA device")


def _dims(u, chunk):
    Bsz, S, di = u.shape
    return (Bsz, S, di, chunk, int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream(u.device).cuda_stream)


def scan_fwd(u, dt, B_t, C_t, A, D, chunk):
    """K4 → (y, h_init)."""
    _check(u, dt, B_t, C_t, A, D, chunk)
    Bsz, S, di = u.shape
    lib = build.load("mamba_scan")
    y = torch.empty_like(u)
    h_init = torch.empty((Bsz, -(-S // chunk), di, D_STATE), dtype=torch.float32,
                         device=u.device)
    build.call(lib.mamba_fwd, u.data_ptr(), dt.data_ptr(), B_t.data_ptr(),
               C_t.data_ptr(), A.data_ptr(), D.data_ptr(), y.data_ptr(),
               h_init.data_ptr(), *_dims(u, chunk))
    LAUNCHES["fwd"] += 1
    return y, h_init


def scan_bwd(u, dt, B_t, C_t, A, D, h_init, dy, chunk):
    """K5 → (du, ddt, dB partial, dC partial, dA partial, dD partial)."""
    Bsz, S, di = u.shape
    N = D_STATE
    _check(u, dt, B_t, C_t, A, D, chunk, (h_init, dy), bwd=True)
    if dy.shape != u.shape or dy.dtype != u.dtype:
        raise ValueError("dy must match u's shape and dtype")
    if h_init.shape != (Bsz, -(-S // chunk), di, N) or h_init.dtype != torch.float32:
        raise ValueError("h_init must be f32 (B, n_chunks, di, N)")
    lib = build.load("mamba_scan")
    f32 = dict(dtype=torch.float32, device=u.device)
    n_cblk = -(-di // C_BLK)
    du, ddt = torch.empty((Bsz, S, di), **f32), torch.empty((Bsz, S, di), **f32)
    dB, dC = (torch.empty((n_cblk, Bsz, S, N), **f32) for _ in range(2))
    dA, dD = torch.empty((Bsz, di, N), **f32), torch.empty((Bsz, di), **f32)
    build.call(lib.mamba_bwd, u.data_ptr(), dt.data_ptr(), B_t.data_ptr(),
               C_t.data_ptr(), A.data_ptr(), D.data_ptr(), h_init.data_ptr(),
               dy.data_ptr(), du.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
               dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), *_dims(u, chunk))
    LAUNCHES["bwd"] += 1
    return du, ddt, dB, dC, dA, dD


class _Scan(torch.autograd.Function):
    """K4 forward, K5 backward (the reference's ``custom_vjp``).  ``plain``
    selects the plain versions whatever the device."""

    @staticmethod
    def forward(ctx, u, dt, B_t, C_t, A, D, chunk, plain):
        fwd = fwd_plain if plain else scan_fwd
        y, h_init = fwd(u, dt, B_t, C_t, A, D, chunk)
        ctx.save_for_backward(u, dt, B_t, C_t, A, D, h_init)
        ctx.chunk, ctx.plain = chunk, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, B_t, C_t, A, D, h_init = ctx.saved_tensors
        bwd = bwd_plain if ctx.plain else scan_bwd
        du, ddt, dB, dC, dA, dD = bwd(u, dt, B_t, C_t, A, D, h_init,
                                      dy.contiguous(), ctx.chunk)
        return (du.to(u.dtype), ddt.to(dt.dtype), dB.sum(0).to(B_t.dtype),
                dC.sum(0).to(C_t.dtype), dA.sum(0).to(A.dtype),
                dD.sum(0).to(D.dtype), None, None)


def mamba_scan_bsd(u, dt, B_t, C_t, A, D, *, chunk: int = CHUNK,
                   plain: bool = False):
    """u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,).
    Returns y: (B, S, di) in u's dtype.  Differentiable in every input.

    The plain versions run on inputs padded to a chunk multiple (dt = 0 makes
    a padded step the identity); pad and slice stay outside the autograd
    Function, as the reference keeps them outside ``custom_vjp``.  The CUDA
    kernels take the inputs as they are."""
    S = u.shape[1]
    u, dt, B_t, C_t, A, D = (t.contiguous() for t in (u, dt, B_t, C_t, A, D))
    plain = plain or build.route(u, "the selective scan") == "plain"
    if plain:
        c, S_p = pick_block(S, chunk)
        u, B_t, C_t = (pad_axis(t, S_p, axis=1) for t in (u, B_t, C_t))
        dt = pad_axis(dt, S_p, axis=1, value=MAMBA_PAD_DT)
    else:
        c = min(chunk, S)
    y = _Scan.apply(u, dt, B_t, C_t, A, D, c, plain)
    return y[:, :S]
