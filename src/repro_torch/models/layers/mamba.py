"""Mamba-1 selective-state-space block (Jamba's SSM half).

Recurrence (per channel c, state dim n):
    h_t = exp(dt_t * A) ⊙ h_{t-1} + (dt_t * x_t) ⊗ B_t
    y_t = h_t · C_t + D ⊙ x_t

Implementations of the scan, chosen by ``impl``:

  * ``naive``  — ``ssm_scan_xla``, a Python loop over time that autograd
                 differentiates (the reference's XLA scan);
  * ``kernel`` — the selective-scan kernels K4/K5 (``kernels/mamba_scan.py``):
                 CUDA on a CUDA tensor, their plain versions on a CPU tensor;
  * ``chunked`` — ``ssm_scan_chunked``, the reference's closed-form chunked
                 XLA scan in plain PyTorch (used outside training).

With a ``shard_ctx`` ``(mesh, batch_axes, model_axes)`` and any impl but
``kernel``, training and prefill scan through ``ssm_scan_sharded``: each
model rank scans its slice of the channels (the naive scan, or the chunked
one for ``chunked``), the reference's ``shard_map`` path on
``torch.distributed`` ranks.  The kernels run unsharded, as the reference's
Pallas path does.

Decode carries (conv window, ssm state) in a cache and steps them in plain
PyTorch, whatever ``impl`` says.

Packed rows.  By default the causal convolution and the scan run across
packed segment boundaries, as in the reference (``segment_ids`` is not
read).  With ``cfg.ssm_segment_reset`` the layer restarts at every segment
start of ``segment_ids`` (a step whose id differs from the step before it;
the padding, id 0, is a segment like any other): the convolution zeroes
every tap that reaches into an earlier segment, and every scan (naive,
chunked, the kernels) starts that step from a zero state, so a packed row
gives each segment what it would give alone.  Decode is unchanged.

``cfg.ssm_inner_norms`` adds Jamba's RMSNorms on dt's low rank, B_t and C_t
after ``x_proj`` (``dt_norm``, ``b_norm``, ``c_norm``; eps ``norm_eps``), in
training and decode alike.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.common.collectives import (as_axes, gather_over, grad_sum_over,
                                            split_over)
from repro_torch.common.types import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import norms
from repro_torch.launch.mesh import axes_size
from repro_torch.sharding.local import is_dtensor

IMPLS = ("naive", "kernel", "chunked")


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
    p = {
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
    if cfg.ssm_inner_norms:
        p.update(dt_norm=norms.rms_init(R, dtype, dev), b_norm=norms.rms_init(N, dtype, dev),
                 c_norm=norms.rms_init(N, dtype, dev))
    return p


def segment_starts(segment_ids):
    """(B, S) bool: the steps t > 0 whose segment id differs from step
    t - 1's (the steps at which a restarting layer drops its state)."""
    starts = torch.zeros(segment_ids.shape, dtype=torch.bool, device=segment_ids.device)
    starts[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    return starts


def conv_taps(starts, K: int):
    """The live taps of a K-wide causal conv over rows that restart at
    ``starts`` ((B, S) bool): K - 1 (B, S) bool masks, the k-th True where
    the tap of x_{t-K+1+k} lies in step t's segment (no start in
    (t - K + 1 + k, t])."""
    S = starts.shape[1]
    run = torch.cumsum(starts.int(), dim=1)
    run_p = F.pad(run, (K - 1, 0))
    return tuple(run_p[:, k:k + S] == run for k in range(K - 1))


class Restarts(NamedTuple):
    """A microbatch's segment restarts, made once for all its Mamba layers
    (``make_restarts``): the start mask, the conv's live taps and, for the
    kernels, their restart words."""
    starts: torch.Tensor
    taps: tuple
    words: Optional[torch.Tensor]


def make_restarts(segment_ids, K: int, kernel: bool = True) -> Restarts:
    """The ``Restarts`` of (B, S) ``segment_ids`` for a K-wide conv; the
    words only with ``kernel``."""
    starts = segment_starts(segment_ids)
    return Restarts(starts, conv_taps(starts, K), kops.start_words(starts) if kernel else None)


def causal_conv(x, conv_w, conv_b, starts=None, taps=None):
    """x: (B, S, di) depthwise causal conv along S; with ``starts`` ((B, S)
    bool, ``segment_starts``), or their ``conv_taps``, a tap that reaches
    into an earlier segment reads zero."""
    B, S, di = x.shape
    K = conv_w.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    if taps is None and starts is not None:
        taps = conv_taps(starts, K)
    # stack K shifted views: y_t = sum_k w[:,k] * x_{t-K+1+k}
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(K):
        tap = xp[:, k:k + S].float()
        if taps is not None and k < K - 1:
            tap = tap * taps[k][..., None]
        y = y + tap * conv_w[:, k].float()
    return (y + conv_b.float()).to(x.dtype)


def ssm_scan_xla(u, dt, B_t, C_t, A, D, starts=None):
    """Sequential selective scan (the naive path).

    u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,); ``starts``
    (B, S) bool or None: the steps that start from a zero state.
    Returns y: (B, S, di) in u's dtype and the final state (B, di, N) f32."""
    b, S, di = u.shape
    N = A.shape[1]
    uf, dtf, bf, cf = (t.float() for t in (u, dt, B_t, C_t))
    keep = None if starts is None else (~starts).float()
    h = torch.zeros((b, di, N), dtype=torch.float32, device=u.device)
    ys = []
    for t in range(S):
        if keep is not None:
            h = h * keep[:, t, None, None]
        decay = torch.exp(dtf[:, t, :, None] * A[None])
        h = h * decay + (dtf[:, t] * uf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, cf[:, t]))
    y = torch.stack(ys, 1) + uf * D.float()[None, None]
    return y.to(u.dtype), h


def ssm_scan_chunked(u, dt, B_t, C_t, A, D, *, chunk: int = 32, h0=None, starts=None):
    """Chunked selective scan: sequential only across chunks.

    With T_t = Σ_{s≤t} dt_s (per channel), the recurrence solves to
        y_tc = Σ_n C_tn [ e^{A_cn T_tc} h0_cn
                          + Σ_{j≤t} e^{A_cn (T_tc − T_jc)} dt_jc u_jc B_jn ]
    Exponents are ≤ 0 (A < 0, T monotone), so the closed intra-chunk form is
    stable.  The chunk is the largest divisor of S not above ``chunk``.
    With ``starts`` ((B, S) bool) a term reaches step t only from its own
    segment: j's where no segment starts in (j, t], and h0 where none
    starts in the chunk up to t.

    u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,).
    Returns (y (B,S,di) in u's dtype, final state (B,di,N) f32)."""
    b, S, di = u.shape
    N = A.shape[1]
    c = min(chunk, S)
    while S % c:
        c -= 1
    n = S // c

    def chunks(t):
        return t.float().reshape(b, n, c, t.shape[-1]).transpose(0, 1)

    uc, dtc, Bc, Cc = map(chunks, (u, dt, B_t, C_t))     # (n,b,c,·)
    # run index of each step within its chunk: 0 until the chunk's first start
    runs = (torch.zeros((n, b, c), device=u.device) if starts is None
            else torch.cumsum(chunks(starts[..., None])[..., 0], dim=2))
    A32 = A.float()
    D32 = D.float()
    h = h0 if h0 is not None else torch.zeros((b, di, N), dtype=torch.float32,
                                              device=u.device)
    tri = torch.ones((c, c), dtype=torch.bool, device=u.device).tril()  # j <= t
    ys = []
    for u_, dt_, b_, c_, q in zip(uc, dtc, Bc, Cc, runs):  # (b,c,di) / (b,c,N) / (b,c)
        T = torch.cumsum(dt_, dim=1)                       # (b,c,di)
        first = (q == 0).float()                           # h0 reaches these steps
        # inter-chunk: y_inter_tc = sum_n C_tn e^{A_cn T_tc} h_cn
        decay_T = torch.exp(T[..., None] * A32[None, None])           # (b,c,di,N)
        y = torch.einsum("btn,btcn,bcn->btc", c_, decay_T, h) * first[..., None]
        # intra-chunk: E_{tjcn} = e^{A_cn (T_t - T_j)}, j <= t in t's segment
        dT = T[:, :, None, :] - T[:, None, :, :]                     # (b,t,j,di)
        E = torch.exp(dT[..., None] * A32[None, None, None])         # (b,t,j,di,N)
        live = tri[None] & (q[:, :, None] == q[:, None, :])          # (b,t,j)
        E = torch.where(live[..., None, None], E, 0.0)
        w = dt_ * u_                                                  # (b,j,di)
        y = y + torch.einsum("btn,btjcn,bjc,bjn->btc", c_, E, w, b_)
        ys.append(y + u_ * D32[None, None])
        # state hand-off
        Tc = T[:, -1]                                                 # (b,di)
        Ec = torch.exp((Tc[:, None, :] - T)[..., None] * A32[None, None])  # (b,c,di,N)
        last = (q == q[:, -1:]).float()                               # (b,j)
        h = h * (torch.exp(Tc[..., None] * A32[None]) * first[:, -1, None, None]) + \
            torch.einsum("bjcn,bjc,bjn->bcn", Ec, w * last[..., None], b_)
    y = torch.stack(ys, 1).reshape(b, S, di)
    return y.to(u.dtype), h


def ssm_scan_sharded(u, dt, B_t, C_t, A, D, shard_ctx, chunked: bool = False,
                     starts=None):
    """The selective scan with its channels split over the model axes of
    ``shard_ctx = (mesh, batch_axes, model_axes)``, on this rank.

    u, dt: (B, S, di), this rank's rows, every channel (replicated over the
    model axes, as the port's layers hold full-width activations); B_t, C_t:
    (B, S, N); A: (di, N); D: (di,).  The rank scans its di / msize channels
    of u, dt, A and D (``ssm_scan_xla``, or ``ssm_scan_chunked`` when
    ``chunked``); B_t and C_t serve every channel slice, so their gradient is
    all-reduced over the model axes once a layer, not a step.  Returns (y
    (B, S, di), every channel, all-gathered; h (B, di / msize, N), this
    rank's channels of the final state).  Backward: u, dt, A and D get their
    whole gradient on every rank (the slices' all-gathered), and y's
    cotangent, which every rank holds whole, is cut to this rank's channels.
    Where the model axes do not divide di, the reference's spec leaves the
    channels replicated: every rank scans all of them.  ``starts`` as the
    unsharded scans take it (every rank's rows, all channels alike)."""
    mesh, _, m_axes = shard_ctx
    m_axes = as_axes(m_axes)
    inner = ssm_scan_chunked if chunked else ssm_scan_xla
    msize = axes_size(mesh, m_axes)
    if msize == 1 or u.shape[-1] % msize:
        return inner(u, dt, B_t, C_t, A, D, starts=starts)
    cut = lambda t, dim: split_over(t, mesh, m_axes, dim)       # noqa: E731
    y, h = inner(cut(u, -1), cut(dt, -1), grad_sum_over(B_t, mesh, m_axes),
                 grad_sum_over(C_t, mesh, m_axes), cut(A, 0), cut(D, 0), starts=starts)
    return gather_over(y, mesh, m_axes, -1), h


def init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device="cuda"):
    di, R, N, K = dims(cfg)
    return {"conv": torch.zeros((batch, K - 1, di), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, di, N), dtype=torch.float32, device=device)}


def _conv_step(conv_state, x_t, conv_w, conv_b):
    """conv_state: (B, K-1, di); x_t: (B, di) -> (y_t, new_state).  Types
    promote as the reference's do (an fp32 window over a bf16 token runs in
    fp32, the weights rounded to the token's type first)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)             # (B,K,di)
    w = conv_w.to(x_t.dtype).to(window.dtype)
    y = torch.einsum("bkc,ck->bc", window, w) + conv_b
    return y, window[:, 1:]


def _project(params, x, cfg: ModelConfig):
    di = dims(cfg)[0]
    xz = x @ params["in_proj"].to(x.dtype)
    return xz[..., :di], xz[..., di:]      # u, z


def _bcdt(params, u, cfg: ModelConfig):
    di, R, N, K = dims(cfg)
    proj = u @ params["x_proj"].to(u.dtype)
    dt_low, B_t, C_t = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    if cfg.ssm_inner_norms:
        dt_low = norms.rms_apply(params["dt_norm"], dt_low, cfg.norm_eps)
        B_t = norms.rms_apply(params["b_norm"], B_t, cfg.norm_eps)
        C_t = norms.rms_apply(params["c_norm"], C_t, cfg.norm_eps)
    dt = F.softplus(dt_low @ params["dt_proj"].to(u.dtype)
                    + params["dt_bias"].to(u.dtype))
    return dt, B_t, C_t


_NAMES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
          "D", "out_proj")


def _apply_dtensor(params, x, cfg: ModelConfig, impl: str, shard_ctx):
    """The layer (training / prefill) on DTensors, inside ``local_map`` as
    Megatron's tensor parallelism over the model axes of ``shard_ctx``:
    each rank takes x's rows (over the batch axes, whole over the model
    axes), the u and z columns of its channel slice from the whole
    ``in_proj``, its channels of the conv, ``x_proj``'s rows, ``dt_proj``'s
    columns, A, D and ``out_proj``'s rows; one all-reduce of the (B, S,
    R + 2N) ``x_proj`` output a layer (identity backward) gives every rank
    dt's low rank and the whole B_t, C_t; the scan runs on the rank's
    channels; the output comes back partial over the model axes.  Without
    model axes, or where they do not divide d_inner, every rank runs every
    channel.  A rank's weight gradients are over its rows (partial over the
    batch axes; ``in_proj``'s over its columns too)."""
    from repro_torch.common.collectives import axis_index, sum_over
    from repro_torch.sharding.local import axes_of, local_call, partial_over, placements
    from repro_torch.sharding.partition import P
    mesh = x.device_mesh
    di, R, N, _ = dims(cfg)
    b = axes_of(x, 0)
    m = tuple(shard_ctx[2]) if shard_ctx is not None else ()
    n = axes_size(mesh, m)
    if n == 1 or di % n:
        m, n = (), 1
    c = m or None
    spec = {"in_proj": P(), "conv_w": P(c, None), "conv_b": P(c), "x_proj": P(c, None),
            "dt_proj": P(None, c), "dt_bias": P(c), "A_log": P(c, None), "D": P(c),
            "out_proj": P(c, None)}
    w_pl = [placements(mesh, spec[k], params[k].shape) for k in _NAMES]
    x_pl = placements(mesh, P(b or None, None, None), x.shape)
    grad_pl = [partial_over(pl, mesh, b + (m if k == "in_proj" else ()))
               for k, pl in zip(_NAMES, w_pl)]

    def local(xl, *ws):
        p = dict(zip(_NAMES, ws))
        dl = di // n
        lo = axis_index(mesh, m) * dl if m else 0
        w_in = p["in_proj"].to(xl.dtype)
        u = xl @ w_in[:, lo:lo + dl]
        z = xl @ w_in[:, di + lo:di + lo + dl]
        u = F.silu(causal_conv(u, p["conv_w"], p["conv_b"]))
        proj = u @ p["x_proj"].to(u.dtype)
        if m:
            proj = sum_over(proj, mesh, m)
        dt_low, B_t, C_t = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
        dt = F.softplus(dt_low @ p["dt_proj"].to(u.dtype) + p["dt_bias"].to(u.dtype))
        A = -torch.exp(p["A_log"].float())
        scan = {"kernel": kops.mamba_scan, "naive": ssm_scan_xla,
                "chunked": ssm_scan_chunked}[impl]
        y = scan(u, dt, B_t, C_t, A, p["D"])[0] * F.silu(z)
        return y @ p["out_proj"].to(xl.dtype)

    return local_call(local, mesh, (x, *(params[k] for k in _NAMES)), (x_pl, *w_pl),
                      partial_over(x_pl, mesh, m), (partial_over(x_pl, mesh, m), *grad_pl))


def apply(params, x, cfg: ModelConfig, *, cache=None, impl: str = "kernel",
          shard_ctx=None, segment_ids=None, restarts: Optional[Restarts] = None):
    """x: (B, S, d) -> (B, S, d), training / prefill without a cache; or
    x (B, 1, d) with the layer's cache -> ((B, 1, d), the cache), its conv
    window and state written in place.  The scan as the reference picks it:
    the kernels, else the sharded scan under ``shard_ctx``, else chunked,
    else naive.  Where ``cfg.ssm_segment_reset`` asks the layer to restart
    at each segment, it takes the rows' ``restarts`` (``make_restarts``,
    made once for every layer of a forward), else makes them from
    ``segment_ids`` ((B, S))."""
    A = -torch.exp(params["A_log"].float())
    D = params["D"]
    if cache is not None:
        x_t = x[:, 0]
        u, z = _project(params, x_t, cfg)
        u_c, conv_state = _conv_step(cache["conv"], u, params["conv_w"],
                                     params["conv_b"])
        u_c = F.silu(u_c)
        dt, B_t, C_t = _bcdt(params, u_c, cfg)
        decay = torch.exp(dt.float()[..., None] * A[None])
        h = cache["ssm"] * decay + (dt * u_c).float()[..., None] \
            * B_t.float()[:, None, :]
        y = torch.einsum("bcn,bn->bc", h, C_t.float())
        y = y + u_c.float() * D.float()[None]
        y = y.to(x.dtype) * F.silu(z)
        out = y @ params["out_proj"].to(x.dtype)
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(h)
        return out[:, None], cache
    if impl not in IMPLS:
        raise ValueError(f"selective-scan impl {impl!r} not in {IMPLS}")
    if is_dtensor(x):
        if cfg.ssm_segment_reset or cfg.ssm_inner_norms:
            raise ValueError(f"{cfg.name}: segment restarts and inner norms do not run on "
                             "DTensors")
        return _apply_dtensor(params, x, cfg, impl, shard_ctx)
    rs = restarts if cfg.ssm_segment_reset else None
    if cfg.ssm_segment_reset and rs is None and segment_ids is not None:
        rs = make_restarts(segment_ids, cfg.ssm_d_conv, impl == "kernel")
    starts = None if rs is None else rs.starts
    u, z = _project(params, x, cfg)
    u = F.silu(causal_conv(u, params["conv_w"], params["conv_b"],
                           taps=None if rs is None else rs.taps))
    dt, B_t, C_t = _bcdt(params, u, cfg)
    if impl == "kernel":
        y, _ = kops.mamba_scan(u, dt, B_t, C_t, A, D, starts=starts,
                               words=None if rs is None else rs.words)
    elif shard_ctx is not None:
        y, _ = ssm_scan_sharded(u, dt, B_t, C_t, A, D, shard_ctx,
                                chunked=impl == "chunked", starts=starts)
    elif impl == "naive":
        y, _ = ssm_scan_xla(u, dt, B_t, C_t, A, D, starts=starts)
    else:
        y, _ = ssm_scan_chunked(u, dt, B_t, C_t, A, D, starts=starts)
    y = y * F.silu(z)
    return y @ params["out_proj"].to(x.dtype)
