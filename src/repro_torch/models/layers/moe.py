"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch (the
reference's train paths, in plain PyTorch: no Pallas kernel lies on them).

Two equivalent dispatch paths:

  * ``dense``    — every expert processes every token, masked combine.
                   O(E/top_k) FLOP inflation; used as the correctness oracle.
  * ``capacity`` — GShard/Switch-style: tokens are scattered into a fixed
                   (E, C, d) buffer (C = ceil(T·k/E·capacity_factor)), expert
                   matmuls run as one batched product, results gathered back.

Both return a Switch-style load-balance auxiliary loss.

``impl="ep"`` with a ``shard_ctx`` ``(mesh, batch_axes, model_axes)`` takes
the reference's ``shard_map`` paths on ``torch.distributed`` ranks
(``apply_ep_shard_map``): expert parallelism where E divides the model axes,
else experts tensor-parallel over d_ff (``_apply_tp_shard_map``).  Each rank
holds its rows of x (replicated over the model axes), the whole router and
its slice of the expert weights (``sharding.expert_shards``); it routes every
local token, and one all-reduce over the model axes combines the experts'
shares.  Without a mesh, or where neither E nor d_ff divides, ``"ep"`` takes
the capacity path, as the reference does.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.collectives import (as_axes, axis_index, grad_sum_over,
                                            sum_over)
from repro_torch.common.types import ModelConfig
from repro_torch.launch.mesh import axes_size
from repro_torch.models.layers.ffn import GATED, _act
from repro_torch.sharding.local import is_dtensor


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
    idx = top_e.reshape(-1)
    # counts by index_add (bincount's length would depend on the data,
    # which a fake tensor does not hold): exact, as bincount's
    counts = torch.zeros(E, dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))
    return counts.float() / top_e.numel()


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


def _capacity(T: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Slots an expert: the reference's Python expression (float floor
    division), not torch's."""
    return int(max(1, -(-T * cfg.top_k * capacity_factor // cfg.n_experts)))  # ceil


def _slots(flat_e, n_exp: int, C: int):
    """Each (token, expert) pair's row in an (n_exp * C, d) buffer: its
    position within its expert's buffer is the running count of the
    expert's one-hot column, in routing order (scanned along the contiguous
    axis of an (n_exp, T*k) one-hot).  ``flat_e`` holds expert ids in
    [0, n_exp), or n_exp for a pair the buffer does not hold.  Returns (row,
    keep); a pair past capacity or not held is clipped to slot C - 1 with
    keep False."""
    onehot = torch.arange(n_exp, device=flat_e.device)[:, None] == flat_e[None]
    e = flat_e.clamp(max=n_exp - 1)
    pos = torch.cumsum(onehot, dim=1).gather(0, e[None])[0] - 1
    keep = (flat_e < n_exp) & (pos < C)
    return e * C + torch.where(keep, pos, C - 1), keep


def _scatter(x2d, row, keep, n_rows: int, k: int):
    """The (n_rows, d) buffer of the kept pairs' token rows.  x2d[repeat(
    arange(T), k)] as a broadcast: its gradient is a sum over k, not a
    scatter-add.  Kept pairs have rows of their own; the others all land on
    slot C - 1 with zero rows (and zero weight, so zero gradient rows), so
    the adds into a shared row add zeros: exact in any order, bitwise
    repeatable even where index_add and its gradient use atomics."""
    T, d = x2d.shape
    rows = x2d[:, None].expand(T, k, d).reshape(T * k, d)
    return torch.zeros((n_rows, d), dtype=x2d.dtype, device=x2d.device).index_add(
        0, row, torch.where(keep[:, None], rows, 0))


def _combine(ye, row, w, T: int, k: int, dtype):
    """y (T, d) = Σ_j w_j · ye[row_j] over each token's k pairs.  The
    reference scatter-adds the T·k rows into y; here they are gathered in
    routing order j-major, (k, T, d), and summed j = 0 .. k-1 (top weight
    first), one add at a time in x's dtype: no atomics, the same sum up to
    rounding."""
    row_j, w_j = (a.view(T, k).T.reshape(-1) for a in (row, w))
    g = (ye.index_select(0, row_j) * w_j[:, None].to(dtype)).view(k, T, -1)
    y = g[0]
    for j in range(1, k):
        y = y + g[j]
    return y


def apply_capacity(params, x, cfg: ModelConfig, *, capacity_factor: float = 1.25,
                   constrain=None, with_stats: bool = False):
    """Scatter/gather dispatch with fixed per-expert capacity.  ``constrain``
    (the reference's) pins the layout of the (E, C, d) buffers.

    With ``with_stats`` also returns {"drop_rate", "imbalance"}: the
    fraction of (token, expert) assignments zeroed by the capacity clip, and
    the routed-load skew (``_load_imbalance``)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    x2d = x.reshape(T, d)
    top_w, top_e, lb_loss = _route(params, x2d, cfg)

    C = _capacity(T, cfg, capacity_factor)
    row, keep = _slots(top_e.reshape(-1), E, C)              # (T*k,) token-major
    flat_w = torch.where(keep, top_w.reshape(-1), 0.0)
    xe = _scatter(x2d, row, keep, E * C, k).view(E, C, d)
    if constrain is not None:
        xe = constrain(xe)
    ye = _expert_ffn(params, xe, cfg)
    if constrain is not None:
        ye = constrain(ye)
    ye = ye.reshape(E * C, d)
    y = _combine(ye, row, flat_w, T, k, x.dtype).reshape(B, S, d)
    if with_stats:
        stats = {"drop_rate": 1.0 - keep.float().sum() / (T * k),
                 "imbalance": _load_imbalance(top_e, E)}
        return y, lb_loss, stats
    return y, lb_loss


def apply_capacity_chunked(params, x, cfg: ModelConfig, *,
                           capacity_factor: float = 1.25, constrain=None,
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
                              constrain=constrain, with_stats=with_stats)
    xc = x.reshape(n_chunks, 1, c, d)
    lb = drop = imb = torch.zeros((), device=x.device)

    def chunk_fn(xi):
        return apply_capacity(params, xi, cfg, capacity_factor=capacity_factor,
                              constrain=constrain, with_stats=True)

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


def _check_slices(params, dims: dict, size: int):
    """Raise unless each expert leaf is this rank's slice (``size`` along
    its ``dims`` entry), as ``sharding.expert_shards`` cuts it: a whole leaf
    would be summed over the ranks."""
    for n, dim in dims.items():
        if n in params and params[n].shape[dim] != size:
            raise ValueError(f"{n} of shape {tuple(params[n].shape)} is not this rank's "
                             f"slice of {size} along dim {dim} (sharding.expert_shards)")


def _mean_over_batch(lb, mesh, b_axes):
    """``lb`` averaged over the batch axes: each data shard's Switch loss,
    then the mean (the reference's ``pmean``, not the loss of the global
    batch); backward the identity, so each shard's share is 1/n."""
    n = axes_size(mesh, b_axes)
    return lb if n == 1 else sum_over(lb, mesh, b_axes) / n


def sharded_path(cfg: ModelConfig, msize: int):
    """The sharded path a layer takes over ``msize`` model ranks: ``"ep"``
    where the experts divide them, else ``"tp"`` where d_ff does (Mixtral's
    8 and Granite's 40 experts on 16), else None (as with one rank)."""
    if msize <= 1:
        return None
    if cfg.n_experts % msize == 0:
        return "ep"
    return "tp" if cfg.d_ff % msize == 0 else None


def apply_ep_shard_map(params, x, cfg: ModelConfig, shard_ctx, *,
                       capacity_factor: float = 1.25):
    """Expert parallelism over the model axes of ``shard_ctx = (mesh,
    batch_axes, model_axes)`` (Megatron-style EP x TP), on this rank.

    Requires E % model size == 0, else the TP-expert path
    (``_apply_tp_shard_map``) where d_ff divides; returns None where neither
    does, or without model axes (size 1).  x: this rank's rows (B, S, d),
    replicated over the model axes; params: the whole router and this rank's
    E / msize experts (``sharding.expert_shards``).  Every rank routes
    all its local tokens, keeps the assignments of its resident experts,
    computes them and all-reduces the partial combine: one (tokens, d)
    all-reduce a layer.  Capacity C is the reference's on the local T.

    Backward: routing, probs and lb are computed alike on every model rank
    and take no collective (so the router's and x's routing gradients are
    not summed msize times); the x a rank scatters into its experts' slots
    and its combine weights each serve only its experts, so their gradients
    are all-reduced over the model axes (``grad_sum_over``); the combine's
    all-reduce has an identity backward (``sum_over``)."""
    mesh, b_axes, m_axes = shard_ctx
    m_axes, b_axes = as_axes(m_axes), as_axes(b_axes)
    E = cfg.n_experts
    msize = axes_size(mesh, m_axes)
    path = sharded_path(cfg, msize)
    if path != "ep":
        return None if path is None else _apply_tp_shard_map(
            params, x, cfg, shard_ctx, capacity_factor=capacity_factor)
    B, S, d = x.shape
    T, k = B * S, cfg.top_k
    E_loc = E // msize
    shard = axis_index(mesh, m_axes)
    _check_slices(params, {"w_up": 0, "w_gate": 0, "w_down": 0}, E_loc)
    x2d = x.reshape(T, d)
    top_w, top_e, lb = _route(params, x2d, cfg)        # alike on every model rank
    C = _capacity(T, cfg, capacity_factor)
    local_e = top_e.reshape(-1) - shard * E_loc
    mine = (local_e >= 0) & (local_e < E_loc)
    row, keep = _slots(torch.where(mine, local_e, E_loc), E_loc, C)
    xs = grad_sum_over(x2d, mesh, m_axes)
    xe = _scatter(xs, row, keep, E_loc * C, k).view(E_loc, C, d)
    ye = _expert_ffn(params, xe, cfg).reshape(E_loc * C, d)
    w_eff = torch.where(keep, grad_sum_over(top_w, mesh, m_axes).reshape(-1), 0.0)
    y = sum_over(_combine(ye, row, w_eff, T, k, x.dtype), mesh, m_axes)
    return y.reshape(B, S, d), _mean_over_batch(lb, mesh, b_axes)


def _apply_tp_shard_map(params, x, cfg: ModelConfig, shard_ctx, *,
                        capacity_factor: float = 1.25):
    """TP-sharded experts with local dispatch (E does not divide the model
    axes): each model rank holds every expert's d_ff / msize slice (w_up,
    w_gate (E, d, ff/m), w_down (E, ff/m, d): ``sharding.expert_shards``);
    routing and dispatch run alike on every rank over its local tokens, and
    the only collective is the all-reduce of ye, the experts' outputs
    (summed in fp32), before the gather.  The x it scatters feeds only its
    d_ff slice: its gradient is all-reduced."""
    mesh, b_axes, m_axes = shard_ctx
    m_axes, b_axes = as_axes(m_axes), as_axes(b_axes)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    _check_slices(params, {"w_up": 2, "w_gate": 2, "w_down": 1},
                  ff // axes_size(mesh, m_axes))
    B, S, _ = x.shape
    T, k = B * S, cfg.top_k
    x2d = x.reshape(T, d)
    top_w, top_e, lb = _route(params, x2d, cfg)
    C = _capacity(T, cfg, capacity_factor)
    row, keep = _slots(top_e.reshape(-1), E, C)
    xe = _scatter(grad_sum_over(x2d, mesh, m_axes), row, keep, E * C, k).view(E, C, d)
    # the expert FFN on the local ff slice; the all-reduce sums the partials
    # in fp32 (msize bf16 partials summed in bf16 would round msize - 1
    # times more than the unsharded path's one rounding of its fp32 sum)
    ye = sum_over(_expert_ffn(params, xe, cfg).float(), mesh, m_axes).to(x.dtype)
    ye = ye.reshape(E * C, d)
    w_eff = torch.where(keep, top_w.reshape(-1), 0.0)
    y = _combine(ye, row, w_eff, T, k, x.dtype)
    return y.reshape(B, S, d), _mean_over_batch(lb, mesh, b_axes)


def _ep_dtensor(params, x, cfg: ModelConfig, shard_ctx, *,
                capacity_factor: float = 1.25):
    """``apply_ep_shard_map`` on DTensors, inside ``local_map`` at the
    reference's specs: x's rows over the batch axes (replicated over the
    model axes), the router whole, the expert leaves cut as ``param_specs``
    cuts them (experts, or d_ff for the TP-expert path; where neither
    divides, whole, and each rank takes the capacity path on its rows).  A
    rank's weight gradients are over its own rows: partial over the batch
    axes."""
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding.local import local_call, partial_over, placements
    from repro_torch.sharding.partition import P
    mesh, b_axes, m_axes = shard_ctx
    m_axes, b_axes = as_axes(m_axes), as_axes(b_axes)
    path = sharded_path(cfg, axes_size(mesh, m_axes))
    m = m_axes or None
    if path == "ep":
        spec = {"router": P(), "w_up": P(m, None, None), "w_gate": P(m, None, None),
                "w_down": P(m, None, None)}
    elif path == "tp":
        spec = {"router": P(), "w_up": P(None, None, m), "w_gate": P(None, None, m),
                "w_down": P(None, m, None)}
    else:     # neither divides: every rank routes its rows through all experts
        spec = {"router": P(), "w_up": P(), "w_gate": P(), "w_down": P()}
    names = [n for n in ("router", "w_up", "w_gate", "w_down") if n in params]
    w_pl = [placements(mesh, spec[n], params[n].shape) for n in names]
    x_pl = placements(mesh, P(b_axes or None, None, None), x.shape)
    scalar = [Replicate()] * len(x_pl)

    def local(xl, *ws):
        if path is None:
            y, lb = apply_capacity(dict(zip(names, ws)), xl, cfg,
                                   capacity_factor=capacity_factor)
            return y, _mean_over_batch(lb, mesh, b_axes)
        return apply_ep_shard_map(dict(zip(names, ws)), xl, cfg, shard_ctx,
                                  capacity_factor=capacity_factor)

    return local_call(local, mesh, (x, *(params[n] for n in names)),
                      (x_pl, *w_pl), (x_pl, scalar),
                      (x_pl, *(partial_over(p, mesh, b_axes) for p in w_pl)))


def apply(params, x, cfg: ModelConfig, *, impl: str = "capacity",
          capacity_factor: float = 1.25, constrain=None, chunk_tokens: int = 0,
          shard_ctx=None, with_stats: bool = False):
    """Dispatch to a MoE path; ``with_stats`` appends a
    {"drop_rate", "imbalance"} dict to the (y, lb) return.  The sharded
    paths do not measure their per-rank dispatch: their stats are NaN,
    never a made-up 0.0."""
    if impl == "dense":
        return apply_dense(params, x, cfg, with_stats=with_stats)
    if impl == "ep" and shard_ctx is not None:
        run = _ep_dtensor if is_dtensor(x) else apply_ep_shard_map
        out = run(params, x, cfg, shard_ctx, capacity_factor=capacity_factor)
        if out is not None:
            if with_stats:
                nan = torch.full((), float("nan"), device=x.device)
                return out[0], out[1], {"drop_rate": nan, "imbalance": nan}
            return out
        # neither E nor d_ff divides the model axes: fall through
    if chunk_tokens:
        return apply_capacity_chunked(params, x, cfg,
                                      capacity_factor=capacity_factor,
                                      constrain=constrain,
                                      chunk_tokens=chunk_tokens,
                                      with_stats=with_stats)
    return apply_capacity(params, x, cfg, capacity_factor=capacity_factor,
                          constrain=constrain, with_stats=with_stats)
