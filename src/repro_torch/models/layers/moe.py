"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch (the
reference's train paths, in plain PyTorch: no Pallas kernel lies on them).

Two equivalent dispatch paths:

  * ``dense``    — every expert processes every token, masked combine.
                   O(E/top_k) FLOP inflation; used as the correctness oracle.
  * ``capacity`` — GShard/Switch-style: tokens are scattered into a fixed
                   (E, C, d) buffer (C = ceil(T·k/E·capacity_factor)), expert
                   matmuls run as one batched product, results gathered back.

Both return a Switch-style load-balance auxiliary loss.  Expert parallelism
(the reference's ``shard_map`` paths) is not ported: ``impl="ep"`` takes the
capacity path, as the reference does without a mesh.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.types import ModelConfig
from repro_torch.models.layers.ffn import GATED, _act


def init(gen, cfg: ModelConfig, dtype=torch.float32):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, device=gen.device) * s).to(dtype)

    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {"router": normal((d, E), s_in), "w_up": normal((E, d, ff), s_in),
         "w_down": normal((E, ff, d), s_out)}
    if cfg.activation in GATED:
        p["w_gate"] = normal((E, d, ff), s_in)
    return p


def _expert_fractions(top_e, E: int):
    """f_e: the share of the T·k routed assignments that go to expert e
    (the reference's mean of one-hots: an exact count over T·k)."""
    return torch.bincount(top_e.reshape(-1), minlength=E).float() / top_e.numel()


def _route(params, x2d, cfg: ModelConfig):
    """x2d: (T, d) -> top-k weights/indices + load-balance loss.

    ``torch.topk`` and ``jax.lax.top_k`` both return the k largest in
    descending order; on exact ties they may pick different experts."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)       # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    # Switch load-balance loss: E * sum_e f_e * p_e
    E = cfg.n_experts
    lb_loss = E * torch.sum(_expert_fractions(top_e, E) * probs.mean(0))
    return top_w, top_e, lb_loss


def _load_imbalance(top_e, E: int):
    """Expert-load imbalance: ``E · max_e(f_e) − 1`` over the routed
    assignment fractions f (0 = perfectly uniform, E − 1 = one expert takes
    everything)."""
    return E * _expert_fractions(top_e, E).max() - 1.0


def _expert_ffn(params, xe, cfg: ModelConfig):
    """xe: (E, C, d) -> (E, C, d), batched over experts."""
    up = torch.bmm(xe, params["w_up"].to(xe.dtype))
    if cfg.activation in GATED:
        h = _act(cfg.activation, torch.bmm(xe, params["w_gate"].to(xe.dtype))) * up
    else:
        h = _act(cfg.activation, up)
    return torch.bmm(h, params["w_down"].to(xe.dtype))


def apply_dense(params, x, cfg: ModelConfig, *, with_stats: bool = False):
    """Oracle path: (B,S,d) -> (B,S,d), every expert sees every token."""
    B, S, d = x.shape
    T, E = B * S, cfg.n_experts
    x2d = x.reshape(T, d)
    top_w, top_e, lb_loss = _route(params, x2d, cfg)
    y_all = _expert_ffn(params, x2d[None].expand(E, T, d), cfg)   # (E, T, d)
    # the k experts of a token are distinct: a scatter, no sum
    combine = torch.zeros((T, E), device=x.device).scatter(1, top_e, top_w)
    y = torch.einsum("te,etd->td", combine.to(x.dtype), y_all).reshape(B, S, d)
    if with_stats:
        stats = {"drop_rate": torch.zeros((), device=x.device),   # dense never drops
                 "imbalance": _load_imbalance(top_e, E)}
        return y, lb_loss, stats
    return y, lb_loss


def apply_capacity(params, x, cfg: ModelConfig, *, capacity_factor: float = 1.25,
                   with_stats: bool = False):
    """Scatter/gather dispatch with fixed per-expert capacity.

    With ``with_stats`` also returns {"drop_rate", "imbalance"}: the
    fraction of (token, expert) assignments zeroed by the capacity clip, and
    the routed-load skew (``_load_imbalance``)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    x2d = x.reshape(T, d)
    top_w, top_e, lb_loss = _route(params, x2d, cfg)

    # the reference's Python expression (float floor division), not torch's
    C = int(max(1, -(-T * k * capacity_factor // E)))        # ceil
    flat_e = top_e.reshape(-1)                               # (T*k,) token-major
    # position of each (token, expert) pair within its expert's buffer: the
    # running count of the expert's one-hot column, scanned along the
    # contiguous axis of an (E, T*k) one-hot
    onehot = torch.arange(E, device=x.device)[:, None] == flat_e[None]
    flat_pos = torch.cumsum(onehot, dim=1).gather(0, flat_e[None])[0] - 1
    keep = flat_pos < C
    flat_w = torch.where(keep, top_w.reshape(-1), 0.0)
    slot = torch.where(keep, flat_pos, C - 1)                # clip (weight 0)
    row = flat_e * C + slot                                  # in the (E*C, d) buffer

    # x2d[repeat(arange(T), k)] as a broadcast: its gradient is a sum over
    # k, not a scatter-add
    rows = x2d[:, None].expand(T, k, d).reshape(T * k, d)
    # Kept pairs have rows of their own; dropped pairs all land on slot
    # C - 1 with zero rows (and zero weight, so zero gradient rows), so the
    # adds into a shared row add zeros: exact in any order, bitwise
    # repeatable even where index_add and its gradient use atomics.
    xe = torch.zeros((E * C, d), dtype=x.dtype, device=x.device).index_add(
        0, row, torch.where(keep[:, None], rows, 0)).view(E, C, d)
    ye = _expert_ffn(params, xe, cfg).reshape(E * C, d)
    # The reference scatter-adds the T·k rows into y.  Here the rows are
    # gathered in routing order j-major, (k, T, d), and each token's k rows
    # are summed j = 0 .. k-1 (top weight first), one add at a time in x's
    # dtype: no atomics, the same sum up to rounding.
    row_j, w_j = (a.view(T, k).T.reshape(-1) for a in (row, flat_w))
    g = (ye.index_select(0, row_j) * w_j[:, None].to(x.dtype)).view(k, T, d)
    y = g[0]
    for j in range(1, k):
        y = y + g[j]
    y = y.reshape(B, S, d)
    if with_stats:
        stats = {"drop_rate": 1.0 - keep.float().sum() / (T * k),
                 "imbalance": _load_imbalance(top_e, E)}
        return y, lb_loss, stats
    return y, lb_loss


def apply_capacity_chunked(params, x, cfg: ModelConfig, *,
                           capacity_factor: float = 1.25,
                           chunk_tokens: int = 8192, with_stats: bool = False):
    """Token-chunked dispatch: bounds the (T·k, d) gather/scatter working set
    to one chunk; each chunk is checkpointed (non-reentrant, so it nests in
    the layer's own checkpoint) so backward recomputes instead of saving
    chunk residuals."""
    B, S, d = x.shape
    T = B * S
    c = min(chunk_tokens, T)
    while T % c:
        c -= 1
    n_chunks = T // c
    if n_chunks == 1:
        return apply_capacity(params, x, cfg, capacity_factor=capacity_factor,
                              with_stats=with_stats)
    xc = x.reshape(n_chunks, 1, c, d)
    lb = drop = imb = torch.zeros((), device=x.device)

    def chunk_fn(xi):
        return apply_capacity(params, xi, cfg, capacity_factor=capacity_factor,
                              with_stats=True)

    ys = []
    for i in range(n_chunks):
        if torch.is_grad_enabled():
            y, lb_c, st = checkpoint(chunk_fn, xc[i], use_reentrant=False)
        else:
            y, lb_c, st = chunk_fn(xc[i])
        ys.append(y)
        lb = lb + lb_c
        if with_stats:
            drop = drop + st["drop_rate"]
            imb = torch.maximum(imb, st["imbalance"])
    y = torch.stack(ys).reshape(B, S, d)
    if with_stats:
        # mean drop over chunks; worst-chunk imbalance (that's the chunk
        # whose expert matmul is the straggler)
        return y, lb / n_chunks, {"drop_rate": drop / n_chunks, "imbalance": imb}
    return y, lb / n_chunks


def apply(params, x, cfg: ModelConfig, *, impl: str = "capacity",
          capacity_factor: float = 1.25, chunk_tokens: int = 0,
          with_stats: bool = False):
    """Dispatch to a MoE path; ``with_stats`` appends a
    {"drop_rate", "imbalance"} dict to the (y, lb) return."""
    if impl == "dense":
        return apply_dense(params, x, cfg, with_stats=with_stats)
    if chunk_tokens:
        return apply_capacity_chunked(params, x, cfg,
                                      capacity_factor=capacity_factor,
                                      chunk_tokens=chunk_tokens,
                                      with_stats=with_stats)
    return apply_capacity(params, x, cfg, capacity_factor=capacity_factor,
                          with_stats=with_stats)
