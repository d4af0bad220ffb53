"""Kernel entry points in the model's layout.

On DTensors (the dry run) each entry point runs inside ``local_map``
(``sharding.local``): the kernels see each rank's shards, batch rows over
the batch axes and heads (attention, WKV6) over the axes that shard
them, as the reference's ``shard_map`` specs place them (the selective
scan runs inside the Mamba layer's own ``local_map``,
``models.layers.mamba``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import mamba_scan_bsd, start_words
from repro_torch.kernels.packed_flash_attention import packed_flash_attention_bkgsd
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bhsm
from repro_torch.sharding.local import is_dtensor


def packed_flash_attention(q, k, v, *, segment_ids=None, causal=True,
                           window=0, block_q=512, block_k=512):
    """q: (B, S, H, D); k, v: (B, S, KH, D); segment_ids: (B, S) int32.
    Returns (B, S, H, D) — layout-matched to the model's attention layer."""
    if is_dtensor(q):
        return _attention_dtensor(q, k, v, segment_ids, causal=causal,
                                  window=window, block_q=block_q, block_k=block_k)
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    if segment_ids is None:
        segment_ids = torch.zeros((B, S), dtype=torch.int32, device=q.device)
    # GQA convention: head h attends through kv head h // G — the
    # (B, S, KH, G, D) reshape groups G consecutive query heads per kv head.
    qt = q.reshape(B, S, KH, G, D).permute(0, 2, 3, 1, 4)   # (B,KH,G,S,D)
    kt = k.permute(0, 2, 1, 3)                              # (B,KH,S,D)
    vt = v.permute(0, 2, 1, 3)
    out = packed_flash_attention_bkgsd(
        qt, kt, vt, segment_ids, segment_ids, causal=causal, window=window,
        block_q=block_q, block_k=block_k)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def rwkv6_scan(r, k, v, w, u):
    """r, k, v, w: (B, S, H, M); u: (H, M).  Returns (y (B, S, H, M), final
    state (B, H, M, M) f32).  u goes in as fp32, as the kernels take it (a
    bf16 parameter converts exactly)."""
    if is_dtensor(r):
        return wkv_dtensor(rwkv6_scan, r, k, v, w, u)
    rt, kt, vt, wt = (t.permute(0, 2, 1, 3) for t in (r, k, v, w))
    y, s = rwkv6_scan_bhsm(rt, kt, vt, wt, u.float())
    return y.permute(0, 2, 1, 3), s


def mamba_scan(u, dt, B_t, C_t, A, D, starts=None, words=None):
    """u, dt: (B, S, di); B_t, C_t: (B, S, N); A: (di, N); D: (di,);
    ``starts`` (B, S) bool, the steps that start a segment (the state
    restarts there), or None; ``words`` their ``start_words``, where the
    caller has them.  Returns (y (B, S, di), None) — no final state, as in
    the reference.  A and D go in as fp32, as the kernels take them (a bf16
    parameter converts exactly)."""
    if words is None and starts is not None:
        words = start_words(starts)
    return mamba_scan_bsd(u, dt, B_t, C_t, A.float(), D.float(), starts=words), None


# --------------------------------------------------------------------------- #
# DTensor inputs: local_map
# --------------------------------------------------------------------------- #
def _attention_dtensor(q, k, v, segment_ids, **kw):
    """Rows over q's batch axes, query heads over the axes that shard q's
    heads.  Where those axes leave the kv heads replicated (fewer kv heads
    than ranks), each rank takes the kv heads its query heads read, and the
    kv gradients come back partial over those axes."""
    from repro_torch.common.collectives import axis_index
    from repro_torch.launch.mesh import axes_size
    from repro_torch.sharding.local import axes_of, local_call, partial_over, placements
    from repro_torch.sharding.partition import P
    mesh = q.device_mesh
    b, h = axes_of(q, 0), axes_of(q, 2)
    H, KH = q.shape[2], k.shape[2]
    G = H // KH
    kv_h = h if KH % axes_size(mesh, h) == 0 else ()
    q_pl = placements(mesh, P(b or None, None, h or None, None), q.shape)
    kv_pl = placements(mesh, P(b or None, None, kv_h or None, None), k.shape)
    kv_grad = partial_over(kv_pl, mesh, () if kv_h else h)
    seg_pl = placements(mesh, P(b or None, None), q.shape[:2])

    def local(ql, kl, vl, sl):
        if not kv_h and h:
            Hl = ql.shape[2]
            kv0 = axis_index(mesh, h) * Hl // G
            kl, vl = (t[:, :, kv0:kv0 + max(1, Hl // G)] for t in (kl, vl))
        return packed_flash_attention(ql, kl, vl, segment_ids=sl, **kw)

    if segment_ids is None:
        segment_ids = torch.zeros(q.shape[:2], dtype=torch.int32, device=q.device)
    return local_call(local, mesh, (q, k, v, segment_ids),
                      (q_pl, kv_pl, kv_pl, seg_pl), q_pl,
                      (q_pl, kv_grad, kv_grad, seg_pl))


def wkv_dtensor(fn, r, k, v, w, u, state0=None):
    """``fn(r, k, v, w, u[, state0]) -> (y, state)`` (a WKV6 scan in the
    model's (B, S, H, M) layout) on DTensors: rows over r's batch axes,
    heads over the axes that shard r's heads (the reference's specs); u's
    gradient is partial over the batch axes."""
    from repro_torch.sharding.local import axes_of, local_call, partial_over, placements
    from repro_torch.sharding.partition import P
    mesh = r.device_mesh
    b, h = axes_of(r, 0), axes_of(r, 2)
    x_pl = placements(mesh, P(b or None, None, h or None, None), r.shape)
    u_pl = placements(mesh, P(h or None, None), u.shape)
    s_pl = placements(mesh, P(b or None, h or None, None, None),
                      (r.shape[0], r.shape[2], r.shape[3], r.shape[3]))
    args, in_pl = (r, k, v, w, u), (x_pl,) * 4 + (u_pl,)
    grad_pl = (x_pl,) * 4 + (partial_over(u_pl, mesh, b),)
    if state0 is not None:
        args, in_pl, grad_pl = args + (state0,), in_pl + (s_pl,), grad_pl + (s_pl,)
    return local_call(fn, mesh, args, in_pl, (x_pl, s_pl), grad_pl)
