"""The plain reference of a dense decoder's training step: RMSNorm, rotary
attention with grouped KV heads over packed segments, SwiGLU, an untied LM
head, mean cross-entropy, microbatch gradient accumulation and AdamW.

Plain PyTorch and nothing else: no kernel, no cache, no library model.  It
follows the published decoder (LLaMA-style blocks as InternLM2 and Qwen2.5
use them) and the training semantics the configuration states:

- the loss of a microbatch is the mean cross-entropy over its labels >= 0;
  a step's loss and gradient are the means over its microbatches;
- the gradient is clipped to a global norm of ``grad_clip`` (scale
  min(1, clip / (norm + 1e-9))), then AdamW with bias correction and
  decoupled weight decay on every leaf but the final norm's scale (the
  stacked-layer layout decays the layers' norm scales too);
- attention is causal within a segment (segment ids; the padding, id 0,
  attends itself), rotary positions restart each segment, split halves.

Departures from the published models, shared with the program: no q/k/v
bias (Qwen2.5 has one), no dynamic rope scaling.

``compute`` is the dtype of activations and matrix products (softmax, norms
and the loss in fp32); ``state`` that of parameters, gradients and moments.
At (float32, float32) it is the reference, run with TF32 off; the control
lowers a precision.  Memory: layers, query blocks and LM-head chunks are
recomputed in the backward (``torch.utils.checkpoint``), so a row of 8192
tokens fits beside the AdamW state.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 2048        # query rows of one attention block
CE_CHUNK = 2048       # tokens of one LM-head and loss chunk


@contextlib.contextmanager
def exact_fp32():
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def rms(x, scale, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x, pos, theta):
    """x (S, heads, hd); pos (S,)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.float()[..., :half], x.float()[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _attend_block(q, k, v, q0):
    """q (KH, G, nq, hd) rows q0.. of a segment; k, v (KH, L, hd)."""
    s = torch.einsum("kgqd,ksd->kgqs", q, k).float() * q.shape[-1] ** -0.5
    qi = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    s = s.masked_fill(ki > qi, float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("kgqs,ksd->kgqd", p, v)


def attention(q, k, v, bounds):
    """q (S, H, hd), k/v (S, KH, hd); ``bounds`` the (start, end) of each
    segment.  Causal within a segment."""
    S, H, hd = q.shape
    KH = k.shape[1]
    outs = []
    for a, b in bounds:
        qs = q[a:b].reshape(b - a, KH, H // KH, hd).permute(1, 2, 0, 3)
        ks, vs = k[a:b].permute(1, 0, 2), v[a:b].permute(1, 0, 2)
        for q0 in range(0, b - a, Q_BLOCK):
            o = checkpoint(_attend_block, qs[:, :, q0:q0 + Q_BLOCK], ks, vs, q0,
                           use_reentrant=False)
            outs.append(o.permute(2, 0, 1, 3).reshape(-1, H, hd))
    return torch.cat(outs, dim=0)


def layer(x, p, i, m, pos, bounds):
    c = x.dtype
    pre = f"layers.{i}."
    h = rms(x, p[pre + "ln1"], m["eps"])
    q = rope(torch.einsum("sd,dhk->shk", h, p[pre + "wq"].to(c)), pos, m["rope_theta"])
    k = rope(torch.einsum("sd,dhk->shk", h, p[pre + "wk"].to(c)), pos, m["rope_theta"])
    v = torch.einsum("sd,dhk->shk", h, p[pre + "wv"].to(c))
    x = x + torch.einsum("shk,hkd->sd", attention(q, k, v, bounds), p[pre + "wo"].to(c))
    h = rms(x, p[pre + "ln2"], m["eps"])
    f = torch.nn.functional.silu(h @ p[pre + "w_gate"].to(c)) * (h @ p[pre + "w_up"].to(c))
    return x + f @ p[pre + "w_down"].to(c)


def _nll_sum(h, w, labels):
    logits = (h @ w.to(h.dtype)).float()
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
    return (nll * (labels >= 0)).sum()


def segment_bounds(seg_row) -> list[tuple[int, int]]:
    seg = np.asarray(seg_row)
    cut = np.flatnonzero(np.diff(seg)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(seg)]])
    return [(int(a), int(b)) for a, b in zip(starts, ends)]


def row_nll_sum(p, m, tokens, labels, seg, pos, compute):
    """Summed cross-entropy over the labels >= 0 of one packed row (numpy
    int arrays (S,))."""
    dev = p["embed"].device
    bounds = segment_bounds(seg)
    t = torch.as_tensor(np.asarray(tokens, np.int64), device=dev)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    ps = torch.as_tensor(np.asarray(pos, np.int64), device=dev)
    x = p["embed"][t].to(compute)
    for i in range(m["layers"]):
        x = checkpoint(layer, x, p, i, m, ps, bounds, use_reentrant=False)
    h = rms(x, p["final_norm"], m["eps"])
    return sum(checkpoint(_nll_sum, h[a:a + CE_CHUNK], p["unembed"], y[a:a + CE_CHUNK],
                          use_reentrant=False)
               for a in range(0, h.shape[0], CE_CHUNK))


def decayed(name: str) -> bool:
    return name != "final_norm"


def train(w0: dict, m: dict, batches: list, opt: dict, *, compute=torch.float32,
          state=torch.float32, fault: str | None = None) -> dict:
    """AdamW steps from the weights ``w0`` (fp32, by leaf name; used as the
    parameters when ``state`` is fp32) on ``batches`` (each a dict of
    (n_mb, rows, S) arrays: tokens, labels, segment_ids, positions).

    Returns each step's loss, the per-leaf norms of the first step's
    gradient as AdamW takes it (after clipping), and the parameters and the
    first moments after the last step.  ``fault`` plants a fault in the reference put in the
    program's place: ``"unchanged"`` (no update), ``"half_batch"`` (the
    step's first half of the microbatches, their mean)."""
    p = {k: (v if v.dtype == state else v.to(state)).requires_grad_(True)
         for k, v in w0.items()}
    mom = {k: torch.zeros_like(v) for k, v in p.items()}
    vel = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad1 = [], {}
    with exact_fp32():
        for step, batch in enumerate(batches):
            n_mb, rows = batch["tokens"].shape[:2]
            use = range(n_mb // 2) if fault == "half_batch" else range(n_mb)
            loss_sum = 0.0
            for i in use:
                # a microbatch's loss: the mean over all its labelled tokens
                count = max(int((np.asarray(batch["labels"][i]) >= 0).sum()), 1)
                for r in range(rows):
                    nll = row_nll_sum(p, m, *(batch[f][i, r] for f in
                                              ("tokens", "labels", "segment_ids", "positions")),
                                      compute) / count
                    (nll / len(use)).backward()
                    loss_sum += float(nll.detach())
            losses.append(loss_sum / len(use))
            with torch.no_grad():
                g = {k: v.grad.float() for k, v in p.items()}
                for v in p.values():
                    v.grad = None
                gnorm = torch.sqrt(sum(torch.sum(x * x) for x in g.values()))
                scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
                if step == 0:
                    grad1 = {k: float(torch.linalg.vector_norm(x * scale)) for k, x in g.items()}
                if fault == "unchanged":
                    continue
                t = step + 1
                bc1, bc2 = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
                for k, v in p.items():
                    gk = g[k] * scale
                    mk = mom[k].float().mul_(opt["b1"]).add_(gk, alpha=1 - opt["b1"])
                    vk = vel[k].float().mul_(opt["b2"]).addcmul_(gk, gk, value=1 - opt["b2"])
                    mom[k].copy_(mk)
                    vel[k].copy_(vk)
                    delta = (mk / bc1) / (torch.sqrt(vk / bc2) + opt["eps"])
                    if decayed(k) and opt["weight_decay"]:
                        delta.add_(v.float(), alpha=opt["weight_decay"])
                    v.copy_((v.float() - opt["lr"] * delta).to(state))
                del g
    return {"losses": losses, "grad1": grad1,
            "params": {k: v.detach() for k, v in p.items()}, "moment": mom}
