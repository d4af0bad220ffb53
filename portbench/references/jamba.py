"""The plain reference of a Jamba training step (HF ``modeling_jamba``):
RMSNorm, Mamba-1 mixers and MQA/GQA attention without positions, SwiGLU
FFNs, the embedding as the LM head, on packed rows, with the loss, clip and
AdamW of ``references/decoder.py``.

Plain PyTorch and nothing else: no kernel of the port, no cache, no library
model.  Each packed segment is a sample of its own: attention is causal
within the segment, and each Mamba mixer runs on the segment alone, its
conv window and state starting from zero at the segment's first token (the
padding, segment 0, too).  The mixer, as ``JambaMambaMixer`` computes it
without its fused kernels:

    x, z  = in_proj(h)                 (no bias)
    x     = silu(causal depthwise conv(x) + conv bias)
    dt_r, B, C = x_proj(x), each through its RMSNorm (eps rms_norm_eps)
    dt    = softplus(dt_proj(dt_r) + dt bias),  A = -exp(A_log)
    h_t   = exp(dt_t A) h_{t-1} + dt_t x_t B_t,   y_t = h_t C_t + D x_t
    out   = out_proj(y * silu(z))      (no bias)

The layer structure comes from the weights' names (``portbench/hybrid.py``):
a layer with ``wq`` is attention, one with ``in_proj`` Mamba.

``compute`` is the dtype of activations and matrix products (norms, the
conv's sums, softmax and the loss in fp32); the scan's state and sums are
fp32 in every mode, as the configuration states.  At (float32, float32) it
is the reference, with TF32 off.  The scan runs in blocks of up to
``SCAN_BLOCK`` steps in closed form (h_t = e^{A T_t} Σ_{j<=t} e^{-A T_j}
dt_j x_j B_j over a block's cumulative dt T, the block's state carried to
the next), each ``SCAN_PIECE`` steps recomputed in the backward, so that a
row of 8192 tokens fits beside the fp32 AdamW state; a block is halved
where its exponents could leave fp32's range.

Departures from the published model, shared with the program: weight decay
on every leaf but the final norm (A_log, D and the biases included), as the
port's AdamW takes it; random weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import core

SCAN_BLOCK = 16        # steps of one closed-form block
SCAN_PIECE = 1024      # steps recomputed together in the backward
EXP_LIMIT = 60.0       # the largest |A| x (a block's sum of dt) taken in one block

# the loss, clip and AdamW of the dense reference, over this module's rows
_dense = core.load_module("references", "decoder")
rms, attention = _dense.rms, _dense.attention
segment_bounds, _nll_sum, CE_CHUNK = _dense.segment_bounds, _dense._nll_sum, _dense.CE_CHUNK


def _scan_piece(x, dt, B, C, A, h0, block: int):
    """Steps of one piece: x, dt (P, di), B, C (P, N) fp32, A (di, N), h0
    (di, N) -> (y (P, di) without D, the piece's last state)."""
    P, di = x.shape
    N = A.shape[1]
    pad = -P % block
    if pad:                                    # dt = 0: an identity step
        x, dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x, dt, B, C))
    n = (P + pad) // block
    T = torch.cumsum(dt.view(n, block, di), dim=1)[..., None]           # (n, c, di, 1)
    w = (dt * x).view(n, block, di, 1) * B.view(n, block, 1, N)         # (n, c, di, N)
    grow, decay = torch.exp(-T * A), torch.exp(T * A)
    s = decay * torch.cumsum(grow * w, dim=1)       # each block's states from zero
    carried, h = [], h0
    # the state into each block (whole-block slices: indexing the big tensors
    # step by step would give each index a backward as large as they are)
    for s_last, d_last in zip(s[:, -1].unbind(0), decay[:, -1].unbind(0)):
        carried.append(h)
        h = s_last + d_last * h
    states = s + decay * torch.stack(carried)[:, None]
    y = torch.einsum("kcdn,kcn->kcd", states, C.view(n, block, N))
    return y.reshape(-1, di)[:P], h


def scan(x, dt, B, C, A):
    """The selective scan of one segment from a zero state, fp32: x, dt (L,
    di), B, C (L, N), A (di, N) -> y (L, di), without D."""
    block = SCAN_BLOCK
    a_max = float(A.detach().abs().max())
    while block > 1:
        sums = F.pad(dt.detach(), (0, 0, 0, -dt.shape[0] % block))
        sums = sums.view(-1, block, dt.shape[1]).sum(1)
        if a_max * float(sums.max()) <= EXP_LIMIT:
            break
        block //= 2
    h = torch.zeros(A.shape, dtype=torch.float32, device=x.device)
    ys = []
    for a in range(0, x.shape[0], SCAN_PIECE):
        y, h = checkpoint(_scan_piece, x[a:a + SCAN_PIECE], dt[a:a + SCAN_PIECE],
                          B[a:a + SCAN_PIECE], C[a:a + SCAN_PIECE], A, h, block,
                          use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=0)


def causal_conv(x, w, b):
    """x (L, di) of one segment, w (di, K), b (di,): y_t = b + Σ_k w_k
    x_{t-K+1+k}, zero before the segment; sums in fp32."""
    K = w.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    y = sum(xp[k:k + x.shape[0]] * w[:, k].float() for k in range(K))
    return (y + b.float()).to(x.dtype)


def mamba(h, p, pre, eps, bounds):
    """The Mamba mixer of a row, one segment at a time."""
    c = h.dtype
    R, N = p[pre + "dt_norm"].shape[0], p[pre + "b_norm"].shape[0]
    di = p[pre + "D"].shape[0]
    A = -torch.exp(p[pre + "A_log"].float())
    outs = []
    for a, b in bounds:
        xz = h[a:b] @ p[pre + "in_proj"].to(c)
        x, z = xz[:, :di], xz[:, di:]
        x = F.silu(causal_conv(x, p[pre + "conv_w"], p[pre + "conv_b"]))
        proj = x @ p[pre + "x_proj"].to(c)
        dt_r = rms(proj[:, :R], p[pre + "dt_norm"], eps)
        B = rms(proj[:, R:R + N], p[pre + "b_norm"], eps)
        C = rms(proj[:, R + N:], p[pre + "c_norm"], eps)
        dt = F.softplus(dt_r @ p[pre + "dt_proj"].to(c) + p[pre + "dt_bias"].to(c))
        y = scan(x.float(), dt.float(), B.float(), C.float(), A)
        y = (y + x.float() * p[pre + "D"].float()).to(c) * F.silu(z)
        outs.append(y @ p[pre + "out_proj"].to(c))
    return torch.cat(outs, dim=0)


def layer(x, p, i, eps, bounds):
    c = x.dtype
    pre = f"layers.{i}."
    h = rms(x, p[pre + "ln1"], eps)
    if pre + "wq" in p:
        q = torch.einsum("sd,dhk->shk", h, p[pre + "wq"].to(c))
        k = torch.einsum("sd,dhk->shk", h, p[pre + "wk"].to(c))
        v = torch.einsum("sd,dhk->shk", h, p[pre + "wv"].to(c))
        x = x + torch.einsum("shk,hkd->sd", attention(q, k, v, bounds), p[pre + "wo"].to(c))
    else:
        x = x + mamba(h, p, pre, eps, bounds)
    h = rms(x, p[pre + "ln2"], eps)
    f = F.silu(h @ p[pre + "w_gate"].to(c)) * (h @ p[pre + "w_up"].to(c))
    return x + f @ p[pre + "w_down"].to(c)


def row_nll_sum(p, m, tokens, labels, seg, pos, compute):
    """Summed cross-entropy over the labels >= 0 of one packed row (numpy
    int arrays (S,)); positions are not read (no positional encoding)."""
    dev = p["embed"].device
    bounds = segment_bounds(seg)
    t = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    x = p["embed"][t].to(compute)
    n_layers = 1 + max(int(k.split(".")[1]) for k in p if k.startswith("layers."))
    for i in range(n_layers):
        x = checkpoint(layer, x, p, i, m["eps"], bounds, use_reentrant=False)
    h = rms(x, p["final_norm"], m["eps"])
    head = p["embed"].t()
    return sum(checkpoint(_nll_sum, h[a:a + CE_CHUNK], head, y[a:a + CE_CHUNK],
                          use_reentrant=False)
               for a in range(0, h.shape[0], CE_CHUNK))


_dense.row_nll_sum = row_nll_sum
train = _dense.train
