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
and counts the launch in ``LAUNCHES``, keyed by kernel and by the shape's
head_dim and causality; on a CPU tensor it runs its plain
version (``fwd_plain``, ``bwd_dq_plain``, ``bwd_dkv_plain``), a blocked
online softmax in torch with the same mask and sentinel.  The CUDA kernels
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

# Kernel launches since the last reset: (kernel, head_dim, causal) -> count,
# kernel one of "fwd" (K1), "bwd_dq" (K2), "bwd_dkv" (K3).
LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _count(kernel: str, q, causal) -> None:
    LAUNCHES[(kernel, q.shape[-1], bool(causal))] += 1


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
def _check(q, k, v, seg_q, seg_k, dout=None, lse=None, delta=None):
    """Raise on what the CUDA kernels do not take."""
    B, KH, G, Sq, D = q.shape
    Sk = k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"CUDA packed flash attention takes head_dim 64 or 128, got {D}")
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
    if B * KH * G > 65535:
        raise ValueError("B * KH * G exceeds the grid's y limit")


def _dims(q, k, causal, window):
    B, KH, G, Sq, D = q.shape
    return (B, KH, G, Sq, k.shape[2], D, int(causal), int(window),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def _fwd_cuda(q, k, v, seg_q, seg_k, causal, window):
    _check(q, k, v, seg_q, seg_k)
    lib = build.load("packed_flash_attention")
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    build.call(lib.pfa_fwd, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               seg_q.data_ptr(), seg_k.data_ptr(), o.data_ptr(), lse.data_ptr(),
               *_dims(q, k, causal, window))
    _count("fwd", q, causal)
    return o, lse


def _bwd_dq_cuda(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window):
    _check(q, k, v, seg_q, seg_k, dout, lse, delta)
    lib = build.load("packed_flash_attention")
    dq = torch.empty_like(q)
    build.call(lib.pfa_bwd_dq, q.data_ptr(), k.data_ptr(), v.data_ptr(),
               seg_q.data_ptr(), seg_k.data_ptr(), dout.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), dq.data_ptr(), *_dims(q, k, causal, window))
    _count("bwd_dq", q, causal)
    return dq


def _bwd_dkv_cuda(q, k, v, seg_q, seg_k, dout, lse, delta, causal, window):
    _check(q, k, v, seg_q, seg_k, dout, lse, delta)
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


_KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
_PLAIN = (fwd_plain, bwd_dq_plain, bwd_dkv_plain)


class _Flash(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the reference's ``custom_vjp``).
    ``plain`` selects the plain versions whatever the device."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, window, block_q, block_k,
                plain):
        fwd = (_PLAIN if plain else _KERNELS)[0]
        o, lse = fwd(q, k, v, seg_q, seg_k, causal, window, block_q, block_k)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, o, lse)
        ctx.args = (causal, window, block_q, block_k)
        ctx.plain = plain
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg_q, seg_k, o, lse = ctx.saved_tensors
        _, dq_fn, dkv_fn = _PLAIN if ctx.plain else _KERNELS
        dout = dout.contiguous()
        # Δ = rowsum(do ⊙ o), outside the kernels as in the reference
        delta = torch.sum(dout.float() * o.float(), dim=-1).contiguous()
        dq = dq_fn(q, k, v, seg_q, seg_k, dout, lse, delta, *ctx.args)
        dk, dv = dkv_fn(q, k, v, seg_q, seg_k, dout, lse, delta, *ctx.args)
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
