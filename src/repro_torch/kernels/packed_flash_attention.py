"""Packed flash attention: CUDA kernels K1–K3, their plain versions, and the
autograd Function that wires them.

Counterpart of ``repro/kernels/packed_flash_attention.py`` (the Pallas TPU
kernels ``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``).  Same
layout and semantics: q is ``(B, KH, G, S, D)`` (G query heads per kv head),
k and v are ``(B, KH, S, D)``, segment ids ``(B, S)`` int32.  The mask is
causal ∧ (``qpos − kpos < window`` if window > 0) ∧ ``seg_q == seg_k``;
scale ``D^-0.5``; a row masked everywhere gives o = 0 and lse = −1e30.

Three wrappers, one per kernel: ``flash_fwd`` (K1), ``flash_bwd_dq`` (K2),
``flash_bwd_dkv`` (K3).  On a CUDA tensor each launches its kernel from
``csrc/packed_flash_attention.cu`` (built on first use, ``kernels/build.py``)
and counts the launch in ``LAUNCHES``, keyed by kernel, route, head_dim and
causality.  The route follows the dtype, explicitly: K1, K2 and K3 in bf16
run on the tensor cores (``"tensor_core"``, wgmma), in fp32 on the CUDA cores
(``"cuda_core"``: TF32 would break the fp32 tolerance), at any head_dim that is
a multiple of 8 up to ``MAX_HEAD_DIM``.  There is no fallback:
a CUDA tensor launches its route's kernel or raises.  On a CPU tensor each
wrapper runs its plain version (``fwd_plain``, ``bwd_dq_plain``,
``bwd_dkv_plain``), a blocked online softmax in torch with the same mask
and sentinel.  The CUDA kernels
tile at a fixed 64 × 64 and mask the ragged edge themselves; the plain
versions tile at ``block_q`` × ``block_k`` and take inputs padded to those
blocks (``kernels/blocking.py``).  Outputs do not depend on the tiling.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import build
from repro_torch.kernels.blocking import PAD_SEGMENT, pad_axis, pick_block

NEG_INF = -1e30

# Kernel launches since the last reset: (kernel, route, head_dim, causal) ->
# count, kernel one of "fwd" (K1), "bwd_dq" (K2), "bwd_dkv" (K3), route one of
# TENSOR_CORE, CUDA_CORE (see ``route_of``).
LAUNCHES: Counter = Counter()
TENSOR_CORE, CUDA_CORE = "tensor_core", "cuda_core"
# The CUDA kernels take any head_dim that is a multiple of 8 up to this; each
# runs at the narrowest tile width of 64, 128 or 256 that holds it (zero
# columns past head_dim, never stored), so D 72 costs what D 128 does.
MAX_HEAD_DIM = 256


def reset_launches() -> None:
    LAUNCHES.clear()


def route_of(dtype) -> str:
    """Which CUDA kernel a launch takes: K1, K2 and K3 run on the tensor
    cores in bf16 and on the CUDA cores in fp32."""
    return TENSOR_CORE if dtype == torch.bfloat16 else CUDA_CORE


def _count(kernel: str, q, causal) -> None:
    LAUNCHES[(kernel, route_of(q.dtype), q.shape[-1], bool(causal))] += 1


# --------------------------------------------------------------------------- #
# Plain versions (torch; inputs padded to the block grid)
# --------------------------------------------------------------------------- #
def _tile_mask(i0, j0, seg_q, seg_k, *, causal: bool, window: int):
    """Boolean (B, 1, 1, bq, bk) attend-mask for the tile at (i0, j0)."""
    bq, bk = seg_q.shape[1], seg_k.shape[1]
    qpos = i0 + torch.arange(bq, device=seg_q.device)[:, None]
    kpos = j0 + torch.arange(bk, device=seg_q.device)[None, :]
    mask = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (qpos - kpos < window)
    return mask[:, None, None]


def fwd_plain(q, k, v, seg_q, seg_k, causal, window, block_q, block_k):
    """Plain K1: returns (o in q's dtype, lse f32 (B, KH, G, Sq))."""
    B, KH, G, Sq, D = q.shape
    Sk = k.shape[2]
    scale = D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    outs, lses = [], []
    for i0 in range(0, Sq, block_q):
        q_i = qf[:, :, :, i0:i0 + block_q]
        m = torch.full(q_i.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q_i)
        for j0 in range(0, Sk, block_k):
            mask = _tile_mask(i0, j0, seg_q[:, i0:i0 + block_q],
                              seg_k[:, j0:j0 + block_k], causal=causal,
                              window=window)
            s = torch.einsum("bkgqd,bksd->bkgqs", q_i,
                             kf[:, :, j0:j0 + block_k]) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            # explicit mask select: a row masked in every tile keeps l = 0
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bksd->bkgqd", p, vf[:, :, j0:j0 + block_k])
            m = m_new
        live = l > 0
        den = torch.clamp(l, min=1e-30)
        outs.append(torch.where(live[..., None], acc / den[..., None], 0.0))
        lses.append(torch.where(live, m + torch.log(den), NEG_INF))
    return torch.cat(outs, 3).to(q.dtype), torch.cat(lses, 3)


def _tile_p_ds(q_i, k_j, v_j, do_i, lse_i, delta_i, mask, scale):
    s = torch.einsum("bkgqd,bksd->bkgqs", q_i, k_j) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - lse_i[..., None]), 0.0)
    dp = torch.einsum("bkgqd,bksd->bkgqs", do_i, v_j)
    return p, p * (dp - delta_i[..., None]) * scale


def bwd_dq_plain(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window,
                 block_q, block_k):
    """Plain K2: dq = Σ_j ds_ij k_j, in q's dtype."""
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    dqs = []
    for i0 in range(0, Sq, block_q):
        sl = slice(i0, i0 + block_q)
        dq_i = torch.zeros_like(qf[:, :, :, sl])
        for j0 in range(0, Sk, block_k):
            sk = slice(j0, j0 + block_k)
            mask = _tile_mask(i0, j0, seg_q[:, sl], seg_k[:, sk],
                              causal=causal, window=window)
            _, ds = _tile_p_ds(qf[:, :, :, sl], kf[:, :, sk], vf[:, :, sk],
                               dof[:, :, :, sl], lse[..., sl], delta[..., sl],
                               mask, D ** -0.5)
            dq_i = dq_i + torch.einsum("bkgqs,bksd->bkgqd", ds, kf[:, :, sk])
        dqs.append(dq_i)
    return torch.cat(dqs, 3).to(q.dtype)


def bwd_dkv_plain(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window,
                  block_q, block_k):
    """Plain K3: dk_j = Σ_i ds_ijᵀ q_i, dv_j = Σ_i p_ijᵀ do_i, summed over
    the G query heads of each kv head."""
    Sq, D = q.shape[3], q.shape[4]
    Sk = k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    dks, dvs = [], []
    for j0 in range(0, Sk, block_k):
        sk = slice(j0, j0 + block_k)
        dk_j = torch.zeros_like(kf[:, :, sk])
        dv_j = torch.zeros_like(dk_j)
        for i0 in range(0, Sq, block_q):
            sl = slice(i0, i0 + block_q)
            mask = _tile_mask(i0, j0, seg_q[:, sl], seg_k[:, sk],
                              causal=causal, window=window)
            p, ds = _tile_p_ds(qf[:, :, :, sl], kf[:, :, sk], vf[:, :, sk],
                               dof[:, :, :, sl], lse[..., sl], delta[..., sl],
                               mask, D ** -0.5)
            dv_j = dv_j + torch.einsum("bkgqs,bkgqd->bksd", p, dof[:, :, :, sl])
            dk_j = dk_j + torch.einsum("bkgqs,bkgqd->bksd", ds, qf[:, :, :, sl])
        dks.append(dk_j)
        dvs.append(dv_j)
    return torch.cat(dks, 2).to(k.dtype), torch.cat(dvs, 2).to(v.dtype)


# --------------------------------------------------------------------------- #
# CUDA launches
# --------------------------------------------------------------------------- #
def _check(kernel, q, k, v, seg_q, seg_k, dout=None, lse=None, delta=None):
    """Raise on what the CUDA kernel of ``kernel`` does not take."""
    B, KH, G, Sq, D = q.shape
    Sk = k.shape[2]
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError("CUDA packed flash attention takes a head_dim that is a multiple "
                         f"of 8 from 8 to {MAX_HEAD_DIM} (16-byte row chunks), got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"CUDA packed flash attention takes bf16 or fp32, got {q.dtype}")
    if k.shape != (B, KH, Sk, D) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if seg_q.shape != (B, Sq) or seg_k.shape != (B, Sk):
        raise ValueError("segment ids must be (B, Sq) and (B, Sk)")
    if seg_q.dtype != torch.int32 or seg_k.dtype != torch.int32:
        raise ValueError("segment ids must be int32")
    if any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError("q, k and v must share one dtype")
    rest = ()
    if dout is not None:
        if dout.shape != q.shape or dout.dtype != q.dtype:
            raise ValueError("dout must match q's shape and dtype")
        if any(t.shape != q.shape[:-1] or t.dtype != torch.float32
               for t in (lse, delta)):
            raise ValueError("lse and delta must be f32 (B, KH, G, Sq)")
        rest = (dout, lse, delta)
    for t in (q, k, v, seg_q, seg_k, *rest):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("operands must be contiguous on q's CUDA device")
    tensor_core = route_of(q.dtype) == TENSOR_CORE
    # grid y: B * KH * G for K1 and the CUDA-core K2, B * KH for the
    # tensor-core K2 and for K3
    per_kv_head = kernel == "bwd_dkv" or (kernel == "bwd_dq" and tensor_core)
    grid_y = B * KH if per_kv_head else B * KH * G
    if grid_y > 65535:
        raise ValueError(f"{kernel}: grid y {grid_y} exceeds the limit of 65535")
    copied = (q, k, v) if dout is None else (q, k, v, dout)
    if tensor_core and any(t.data_ptr() % 16 for t in copied):
        raise ValueError("the tensor-core kernels copy 16-byte chunks: q, k, v and "
                         "dout must start on a 16-byte boundary")


def _dims(q, k, causal, window):
    B, KH, G, Sq, D = q.shape
    return (B, KH, G, Sq, k.shape[2], D, int(causal), int(window),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def _fwd_cuda(q, k, v, seg_q, seg_k, causal, window):
    _check("fwd", q, k, v, seg_q, seg_k)
    lib = build.load("packed_flash_attention")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    build.call(lib.pfa_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               seg_q.data_ptr(), seg_k.data_ptr(), o.data_ptr(), lse.data_ptr(),
               *_dims(q, k, causal, window))
    _count("fwd", q, causal)
    return o, lse


def _bwd_dq_cuda(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window):
    _check("bwd_dq", q, k, v, seg_q, seg_k, dout, lse, delta)
    lib = build.load("packed_flash_attention")
    dq = torch.empty_like(q)
    build.call(lib.pfa_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               seg_q.data_ptr(), seg_k.data_ptr(), dout.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), dq.data_ptr(), *_dims(q, k, causal, window))
    _count("bwd_dq", q, causal)
    return dq


def _bwd_dkv_cuda(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window):
    _check("bwd_dkv", q, k, v, seg_q, seg_k, dout, lse, delta)
    lib = build.load("packed_flash_attention")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    build.call(lib.pfa_bwd_dkv, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               seg_q.data_ptr(), seg_k.data_ptr(), dout.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               *_dims(q, k, causal, window))
    _count("bwd_dkv", q, causal)
    return dk, dv


# --------------------------------------------------------------------------- #
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# --------------------------------------------------------------------------- #
def flash_fwd(q, k, v, seg_q, seg_k, causal, window, block_q, block_k):
    """K1 → (o, lse)."""
    if build.route(q, "packed flash attention") == "kernel":
        return _fwd_cuda(q, k, v, seg_q, seg_k, causal, window)
    return fwd_plain(q, k, v, seg_q, seg_k, causal, window, block_q, block_k)


def flash_bwd_dq(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window,
                 block_q, block_k):
    """K2 → dq."""
    if build.route(q, "packed flash attention") == "kernel":
        return _bwd_dq_cuda(q, k, v, seg_q, seg_k, dout, lse, delta, causal,
                            window)
    return bwd_dq_plain(q, k, v, seg_q, seg_k, dout, lse, delta, causal,
                        window, block_q, block_k)


def flash_bwd_dkv(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window,
                  block_q, block_k):
    """K3 → (dk, dv)."""
    if build.route(q, "packed flash attention") == "kernel":
        return _bwd_dkv_cuda(q, k, v, seg_q, seg_k, dout, lse, delta, causal,
                             window)
    return bwd_dkv_plain(q, k, v, seg_q, seg_k, dout, lse, delta, causal,
                         window, block_q, block_k)


# --------------------------------------------------------------------------- #
# The entry points as torch ops: a real tensor takes the wrapper of its
# kind (the kernel, or with ``plain`` the plain version); a fake tensor (the
# dry run's, ``launch/dryrun.py``) takes the shape-only implementation and
# never reaches ctypes.  Their FLOP formulas count the §6 bound's operations
# at a dense mask (a fake tensor has no segment ids to read): 4·D a (q, k)
# pair and query head forward, 1.5x that for K2, 2x for K3.
# --------------------------------------------------------------------------- #
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::pfa_fwd", mutates_args=())
def pfa_fwd_op(q: Tensor, k: Tensor, v: Tensor, seg_q: Tensor, seg_k: Tensor,
               causal: bool, window: int, block_q: int, block_k: int,
               plain: bool) -> tuple[Tensor, Tensor]:
    """K1 (or ``fwd_plain``) → (o, lse)."""
    fwd = fwd_plain if plain else flash_fwd
    return fwd(q, k, v, seg_q, seg_k, causal, window, block_q, block_k)


@pfa_fwd_op.register_fake
def _(q, k, v, seg_q, seg_k, causal, window, block_q, block_k, plain):
    return torch.empty_like(q), q.new_empty(q.shape[:-1], dtype=torch.float32)


@torch.library.custom_op("repro_torch::pfa_bwd_dq", mutates_args=())
def pfa_bwd_dq_op(q: Tensor, k: Tensor, v: Tensor, seg_q: Tensor, seg_k: Tensor,
                  dout: Tensor, lse: Tensor, delta: Tensor, causal: bool,
                  window: int, block_q: int, block_k: int, plain: bool) -> Tensor:
    """K2 (or ``bwd_dq_plain``) → dq."""
    fn = bwd_dq_plain if plain else flash_bwd_dq
    return fn(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window,
              block_q, block_k)


@pfa_bwd_dq_op.register_fake
def _(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window, block_q,
      block_k, plain):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::pfa_bwd_dkv", mutates_args=())
def pfa_bwd_dkv_op(q: Tensor, k: Tensor, v: Tensor, seg_q: Tensor, seg_k: Tensor,
                   dout: Tensor, lse: Tensor, delta: Tensor, causal: bool,
                   window: int, block_q: int, block_k: int,
                   plain: bool) -> tuple[Tensor, Tensor]:
    """K3 (or ``bwd_dkv_plain``) → (dk, dv)."""
    fn = bwd_dkv_plain if plain else flash_bwd_dkv
    return fn(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window,
              block_q, block_k)


@pfa_bwd_dkv_op.register_fake
def _(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window, block_q,
      block_k, plain):
    return torch.empty_like(k), torch.empty_like(v)


def fwd_ops(q_shape, k_shape) -> float:
    """K1's operations at a dense mask: 4·D·H·B·Sq·Sk."""
    B, KH, G, Sq, D = q_shape
    return 4.0 * D * KH * G * B * Sq * k_shape[2]


def _register_flops():
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.pfa_fwd)
    def _fwd(q, k, *args, **kwargs):
        return int(fwd_ops(q, k))

    @register_flop_formula(torch.ops.repro_torch.pfa_bwd_dq)
    def _dq(q, k, *args, **kwargs):
        return int(1.5 * fwd_ops(q, k))

    @register_flop_formula(torch.ops.repro_torch.pfa_bwd_dkv)
    def _dkv(q, k, *args, **kwargs):
        return int(2.0 * fwd_ops(q, k))


_register_flops()


class _Flash(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the reference's ``custom_vjp``), through
    the ops above.  ``plain`` selects the plain versions whatever the
    device."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, window, block_q, block_k,
                plain):
        o, lse = torch.ops.repro_torch.pfa_fwd(q, k, v, seg_q, seg_k, causal,
                                               window, block_q, block_k, plain)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.args = (causal, window, block_q, block_k, plain)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # Δ = rowsum(do ⊙ o), outside the kernels as in the reference
        delta = torch.sum(dout.float() * o.float(), dim=-1).contiguous()
        args = (q, k, v, seg_q, seg_k, dout, lse, delta, *ctx.args)
        dq = torch.ops.repro_torch.pfa_bwd_dq(*args)
        dk, dv = torch.ops.repro_torch.pfa_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None, None, None, None


def packed_flash_attention_bkgsd(q, k, v, seg_q, seg_k, *, causal: bool = True,
                                 window: int = 0, block_q: int = 512,
                                 block_k: int = 512, plain: bool = False):
    """q: (B, KH, G, Sq, D); k, v: (B, KH, Sk, D); seg_*: (B, S) int32.
    Returns (B, KH, G, Sq, D).  Differentiable in (q, k, v).

    The plain versions run on padded inputs (pad and slice stay outside the
    autograd Function, as the reference keeps them outside ``custom_vjp``);
    the CUDA kernels mask the ragged edge and take the inputs as they are."""
    Sq, Sk = q.shape[3], k.shape[2]
    bq, Sq_p = pick_block(Sq, block_q)
    bk, Sk_p = pick_block(Sk, block_k)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    seg_q = seg_q.to(torch.int32).contiguous()
    seg_k = seg_k.to(torch.int32).contiguous()
    plain = plain or build.route(q, "packed flash attention") == "plain"
    if plain:
        q = pad_axis(q, Sq_p, axis=3)
        seg_q = pad_axis(seg_q, Sq_p, axis=1, value=PAD_SEGMENT)
        k = pad_axis(k, Sk_p, axis=2)
        v = pad_axis(v, Sk_p, axis=2)
        seg_k = pad_axis(seg_k, Sk_p, axis=1, value=PAD_SEGMENT)
    out = _Flash.apply(q, k, v, seg_q, seg_k, causal, window, bq, bk, plain)
    return out[:, :, :, :Sq]
