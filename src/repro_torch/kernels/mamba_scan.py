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

Packed rows: ``starts``, the segment restart bits of each row
(``start_words``: (B, ceil(S / 32)) int32 words, bit t % 32 of word
t / 32 set where step t starts a segment), makes such a step drop the state
it inherits, ``h_t = (dt_t u_t) ⊗ B_t``, in both kernels and both plain
versions; the backward then stops the state's gradient there, and the
step's decay takes no gradient.  ``None`` runs across the segments, as the
reference does.

The chunk is internal (no output depends on it): ``CHUNK`` steps.  K4 takes
any chunk (it walks the sequence in tiles of ``K4_TILE`` steps in bf16, half
that in fp32, and saves the state where a countdown names a chunk's start).
K5 keeps a chunk's replay history in registers, unrolled over ``K5_CHUNK``
steps, so it takes chunks of at most that many.  The plain versions take
inputs padded to a chunk multiple (dt = 0: a padded step is the identity);
the CUDA kernels load that value past the end.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.blocking import MAMBA_PAD_DT, pad_axis, pick_block

CHUNK = 16
K5_CHUNK = 16        # the longest chunk K5 takes (K5_CH in the .cu)
K4_TILE = 64         # the steps K4 copies in at a time in bf16, half in fp32 (K4<T, N>::TS)
C_BLK = 128          # channels per CUDA block (CB in the .cu)
D_STATE = 16         # the state width the CUDA kernels take

# Kernel launches since the last reset: kernel ("fwd" K4, "bwd" K5) -> count;
# "fwd_restarts", "bwd_restarts": those of them that took restart words.
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def start_words(starts):
    """The restart bits of packed rows: a (B, S) bool mask of the steps that
    start a segment -> (B, ceil(S / 32)) int32 words, bit t % 32 of word
    t / 32 set where step t does."""
    Bsz, S = starts.shape
    start = pad_axis(starts.long(), -(-S // 32) * 32, axis=1)
    shifts = torch.arange(32, device=starts.device, dtype=torch.int64)
    words = (start.view(Bsz, -1, 32) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32).contiguous()


def start_mask(starts, S):
    """The words of ``start_words`` back as a (B, S) bool mask (steps
    past the words' end: no start)."""
    bits = (starts.long()[..., None] >> torch.arange(32, device=starts.device)) & 1
    bits = bits.reshape(starts.shape[0], -1)[:, :S].bool()
    return pad_axis(bits, S, axis=1, value=False)


# --------------------------------------------------------------------------- #
# Plain versions (torch; S a multiple of chunk)
# --------------------------------------------------------------------------- #
def fwd_plain(u, dt, B_t, C_t, A, D, chunk, starts=None):
    """Plain K4: (y in u's dtype, h_init f32 (B, n_chunks, di, N)); with
    ``starts``, the state restarts where a segment starts (h_init holds each
    chunk's pre-state, before the restart)."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    uf, dtf, bf, cf = (t.float() for t in (u, dt, B_t, C_t))
    Af, Df = A.float(), D.float()
    keep = None if starts is None else (~start_mask(starts, S)).float()
    h = torch.zeros((Bsz, di, N), dtype=torch.float32, device=u.device)
    ys, inits = [], []
    for t in range(S):
        if t % chunk == 0:
            inits.append(h)
        if keep is not None:
            h = h * keep[:, t, None, None]
        decay = torch.exp(dtf[:, t, :, None] * Af)
        h = h * decay + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.sum(h * cf[:, t, None, :], -1) + Df * uf[:, t])
    return torch.stack(ys, 1).to(u.dtype), torch.stack(inits, 1)


def bwd_plain(u, dt, B_t, C_t, A, D, h_init, dy, chunk, starts=None):
    """Plain K5: du, ddt f32 (B, S, di); dB, dC partials f32
    (n_cblk, B, S, N) over blocks of C_BLK channels; dA partial f32
    (B, di, N); dD partial f32 (B, di).  With ``starts``, a step that
    starts a segment has a zero pre-state and passes no gradient back to
    it."""
    Bsz, S, di = u.shape
    N = A.shape[1]
    n_cblk = -(-di // C_BLK)
    uf, dtf, bf, cf, dyf = (t.float() for t in (u, dt, B_t, C_t, dy))
    Af, Df = A.float(), D.float()
    keep = (torch.ones((Bsz, S), device=u.device) if starts is None
            else (~start_mask(starts, S)).float())
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
            h = h * keep[:, t, None, None]
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
            g = gt * decay * keep[:, t, None, None]
    return du, ddt, dB, dC, dA, dD


# --------------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------------- #
def _check(u, dt, B_t, C_t, A, D, chunk, extra=(), bwd=False, starts=None):
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
    if starts is not None and (starts.dtype != torch.int32
                               or starts.shape != (Bsz, -(-S // 32))):
        raise ValueError("starts must be int32 (B, ceil(S / 32)) words (start_words)")
    for t in (u, dt, B_t, C_t, A, D, *extra, *(() if starts is None else (starts,))):
        if t.device != u.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous on u's CUDA device")


def _dims(u, chunk):
    Bsz, S, di = u.shape
    return (Bsz, S, di, chunk, int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream(u.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def scan_fwd(u, dt, B_t, C_t, A, D, chunk, starts=None):
    """K4 → (y, h_init)."""
    _check(u, dt, B_t, C_t, A, D, chunk, starts=starts)
    Bsz, S, di = u.shape
    lib = build.load("mamba_scan")
    y = torch.empty_like(u)
    h_init = torch.empty((Bsz, -(-S // chunk), di, D_STATE), dtype=torch.float32,
                         device=u.device)
    build.call(lib.mamba_fwd, u.data_ptr(), dt.data_ptr(), B_t.data_ptr(),
               C_t.data_ptr(), A.data_ptr(), D.data_ptr(), y.data_ptr(),
               h_init.data_ptr(), _ptr(starts), *_dims(u, chunk))
    LAUNCHES["fwd"] += 1
    LAUNCHES["fwd_restarts"] += starts is not None
    return y, h_init


def scan_bwd(u, dt, B_t, C_t, A, D, h_init, dy, chunk, starts=None):
    """K5 → (du, ddt, dB partial, dC partial, dA partial, dD partial)."""
    Bsz, S, di = u.shape
    N = D_STATE
    _check(u, dt, B_t, C_t, A, D, chunk, (h_init, dy), bwd=True, starts=starts)
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
               dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), _ptr(starts),
               *_dims(u, chunk))
    LAUNCHES["bwd"] += 1
    LAUNCHES["bwd_restarts"] += starts is not None
    return du, ddt, dB, dC, dA, dD


# --------------------------------------------------------------------------- #
# The entry points as torch ops: a real tensor takes the kernel (or with
# ``plain`` the plain version); a fake tensor (the dry run's,
# ``launch/dryrun.py``) takes the shape-only implementation and never
# reaches ctypes.  FLOP formulas: the reference's selective-scan count
# (``bench.mamba_flops``), the backward at 2x, as the §6 bounds count them.
# --------------------------------------------------------------------------- #
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::mamba_fwd", mutates_args=())
def mamba_fwd_op(u: Tensor, dt: Tensor, B_t: Tensor, C_t: Tensor, A: Tensor,
                 D: Tensor, chunk: int, plain: bool,
                 starts: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """K4 (or ``fwd_plain``) → (y, h_init)."""
    return (fwd_plain if plain else scan_fwd)(u, dt, B_t, C_t, A, D, chunk, starts)


@mamba_fwd_op.register_fake
def _(u, dt, B_t, C_t, A, D, chunk, plain, starts=None):
    Bsz, S, di = u.shape
    return torch.empty_like(u), u.new_empty(
        (Bsz, -(-S // chunk), di, A.shape[1]), dtype=torch.float32)


@torch.library.custom_op("repro_torch::mamba_bwd", mutates_args=())
def mamba_bwd_op(u: Tensor, dt: Tensor, B_t: Tensor, C_t: Tensor, A: Tensor,
                 D: Tensor, h_init: Tensor, dy: Tensor, chunk: int, plain: bool,
                 starts: Optional[Tensor] = None) -> tuple[Tensor, Tensor, Tensor,
                                                           Tensor, Tensor, Tensor]:
    """K5 (or ``bwd_plain``) → (du, ddt, dB, dC, dA, dD partials)."""
    return (bwd_plain if plain else scan_bwd)(u, dt, B_t, C_t, A, D, h_init,
                                              dy, chunk, starts)


@mamba_bwd_op.register_fake
def _(u, dt, B_t, C_t, A, D, h_init, dy, chunk, plain, starts=None):
    Bsz, S, di = u.shape
    N = A.shape[1]
    f32 = lambda *shape: u.new_empty(shape, dtype=torch.float32)   # noqa: E731
    n_cblk = -(-di // C_BLK)
    return (f32(Bsz, S, di), f32(Bsz, S, di), f32(n_cblk, Bsz, S, N),
            f32(n_cblk, Bsz, S, N), f32(Bsz, di, N), f32(Bsz, di))


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    def ops(u, A):
        return 6.0 * u[0] * u[1] * u[2] * A[1]     # bench.mamba_flops

    @register_flop_formula(torch.ops.repro_torch.mamba_fwd)
    def _fwd(u, dt, B_t, C_t, A, *args, **kwargs):
        return int(ops(u, A))

    @register_flop_formula(torch.ops.repro_torch.mamba_bwd)
    def _bwd(u, dt, B_t, C_t, A, *args, **kwargs):
        return int(2 * ops(u, A))


_register_flops()


class _Scan(torch.autograd.Function):
    """K4 forward, K5 backward (the reference's ``custom_vjp``), through the
    ops above.  ``plain`` selects the plain versions whatever the device;
    ``starts`` (or None) the segment restarts."""

    @staticmethod
    def forward(ctx, u, dt, B_t, C_t, A, D, chunk, plain, starts):
        y, h_init = torch.ops.repro_torch.mamba_fwd(u, dt, B_t, C_t, A, D,
                                                    chunk, plain, starts)
        ctx.save_for_backward(u, dt, B_t, C_t, A, D, h_init, starts)
        ctx.chunk, ctx.plain = chunk, plain
        return y

    @staticmethod
    def backward(ctx, dy):
        u, dt, B_t, C_t, A, D, h_init, starts = ctx.saved_tensors
        du, ddt, dB, dC, dA, dD = torch.ops.repro_torch.mamba_bwd(
            u, dt, B_t, C_t, A, D, h_init, dy.contiguous(), ctx.chunk, ctx.plain,
            starts)
        return (du.to(u.dtype), ddt.to(dt.dtype), dB.sum(0).to(B_t.dtype),
                dC.sum(0).to(C_t.dtype), dA.sum(0).to(A.dtype),
                dD.sum(0).to(D.dtype), None, None, None)


def mamba_scan_bsd(u, dt, B_t, C_t, A, D, *, chunk: int = CHUNK,
                   plain: bool = False, starts=None):
    """u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,);
    ``starts`` the rows' segment restart words (``start_words``) or
    None.  Returns y: (B, S, di) in u's dtype.  Differentiable in every
    input.

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
    y = _Scan.apply(u, dt, B_t, C_t, A, D, c, plain, starts)
    return y[:, :S]
