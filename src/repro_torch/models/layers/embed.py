"""Token embedding / unembedding."""
from __future__ import annotations

import torch

from repro_torch.sharding.local import is_dtensor


def init(gen, vocab: int, d: int, dtype=torch.float32, scale: float = 0.02):
    w = torch.randn((vocab, d), generator=gen, device=gen.device) * scale
    return {"w": w.to(dtype)}


def encode(params, tokens, dtype=None):
    if is_dtensor(params["w"]):
        out = _encode_dtensor(params["w"], tokens)
    else:
        out = params["w"][tokens.long()]
    return out.to(dtype) if dtype is not None else out


def _encode_dtensor(w, tokens):
    """The lookup on DTensors, inside ``local_map`` (Megatron's vocab-parallel
    embedding): rows of tokens over their batch axes; where the table's
    vocab is sharded, each rank looks up the ids in its slice, zeros the
    rest, and the rows come back partial over those axes (a sum completes
    them).  The table's gradient is partial over the batch axes."""
    from repro_torch.common.collectives import axis_index
    from repro_torch.sharding.local import axes_of, local_call, partial_over, placements
    from repro_torch.sharding.partition import P
    mesh = w.device_mesh
    b, v = axes_of(tokens, 0), axes_of(w, 0)
    w_pl = placements(mesh, P(v or None, None), w.shape)
    t_pl = placements(mesh, P(b or None, *(None,) * (tokens.ndim - 1)), tokens.shape)
    out_pl = partial_over(placements(mesh, P(b or None, *(None,) * tokens.ndim),
                                     (*tokens.shape, w.shape[1])), mesh, v)

    def local(wl, tl):
        ids = tl.long()
        if not v:
            return wl[ids]
        ids = ids - axis_index(mesh, v) * wl.shape[0]
        mine = (ids >= 0) & (ids < wl.shape[0])
        rows = wl[ids.clamp(0, wl.shape[0] - 1)]
        return torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                device=rows.device))

    return local_call(local, mesh, (w, tokens), (w_pl, t_pl), out_pl,
                      (partial_over(w_pl, mesh, b), t_pl))


def decode(params, h):
    return torch.einsum("bsd,vd->bsv", h, params["w"].to(h.dtype))


def unembed_init(gen, d: int, vocab: int, dtype=torch.float32):
    w = torch.randn((d, vocab), generator=gen, device=gen.device) * d ** -0.5
    return {"w": w.to(dtype)}


def unembed(params, h):
    return h @ params["w"].to(h.dtype)
