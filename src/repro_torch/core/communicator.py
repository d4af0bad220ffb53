"""Inter-model Communicator (paper §4, Fig. 6).

The paper's problem: the encoder's data-parallel groups and the LLM's
data-parallel groups differ in size (e.g. E_dp=4 vs L_dp=2), so activations
must be gathered from the encoder groups and re-scattered to the LLM groups
in the forward pass (reversed for gradients).

Each rank holds its own rows of a (B, T, D) activation.  Under the encoder's
assignment rank r holds the rows of its index over ``enc.batch``; under the
LLM's, those of its index over ``llm.batch`` (replicated over the other
axes).  ``make_communicator`` moves a rank's rows from the first layout to
the second: it all-gathers over the encoder's batch axes past the prefix the
two share, then keeps the LLM's rows.  Its backward is the reverse reshard,
from the LLM's layout to the encoder's (Fig. 6's gradient path): the
cotangent of a row replicated over an axis is already the full one on every
rank of it, so nothing is summed.

``explicit_gather_scatter`` is the paper's designated-rank mechanism along
one axis, kept for validation: an all-gather (backward reduce-scatter, the
transpose ``shard_map`` gives it) and a slice of the rank's own shard.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.collectives import all_gather, as_axes, axis_index
from repro_torch.launch.mesh import axes_size, mesh_shape
from repro_torch.sharding.local import is_dtensor
from repro_torch.sharding.partition import P, AxisAssignment, sanitize_spec


def _reshard(x, mesh, src: tuple, dst: tuple):
    """Rows of a batch sharded over ``src`` -> rows sharded over ``dst``."""
    k = 0
    while k < min(len(src), len(dst)) and src[k] == dst[k]:
        k += 1
    for a in reversed(src[k:]):              # minor axis first: contiguous blocks
        x = all_gather(x, mesh, a)
    n, i = axes_size(mesh, dst[k:]), axis_index(mesh, dst[k:])
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows].contiguous()


class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, src, dst):
        ctx.mesh, ctx.src, ctx.dst = mesh, src, dst
        return _reshard(x, mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        return _reshard(g, ctx.mesh, ctx.dst, ctx.src), None, None, None


def make_communicator(mesh, enc: AxisAssignment,
                      llm: AxisAssignment) -> Callable:
    """Returns f(x) resharding a rank's (B, T, D) rows from the encoder
    layout to the LLM layout (identity if the layouts coincide)."""
    sizes = mesh_shape(mesh)

    def communicate(x):
        if is_dtensor(x):
            return _communicate_dtensor(mesh, enc, llm, x)
        # the LLM's batch axes that divide the global batch, as the
        # reference sanitises its constraint; axes of size 1 move nothing
        src = tuple(enc.batch)
        b = x.shape[0] * axes_size(mesh, src)
        spec = sanitize_spec(P(tuple(llm.batch) or None, None, None),
                             (b, *x.shape[1:]), mesh)
        dst = as_axes(spec[0] if len(spec) else None)
        src = tuple(a for a in src if sizes[a] > 1)
        dst = tuple(a for a in dst if sizes[a] > 1)
        if src == dst:
            return x
        return _Reshard.apply(x, mesh, src, dst)

    return communicate


def _communicate_dtensor(mesh, enc: AxisAssignment, llm: AxisAssignment, x):
    """The communicator on a DTensor, inside ``local_map``: rows in over the
    encoder's batch axes that divide the batch, out over the LLM's (each
    sanitised as the reference sanitises its specs), moved by ``_Reshard``."""
    from repro_torch.sharding.local import local_call, placements
    sizes = mesh_shape(mesh)
    rest = (None,) * (x.ndim - 1)
    pl, axes = [], []
    for a in (enc, llm):
        spec = sanitize_spec(P(tuple(a.batch) or None, *rest), tuple(x.shape), mesh)
        pl.append(placements(mesh, spec, x.shape))
        axes.append(tuple(ax for ax in as_axes(spec[0] if len(spec) else None)
                          if sizes[ax] > 1))
    src, dst = axes

    def move(xl):
        return xl.view_as(xl) if src == dst else _Reshard.apply(xl, mesh, src, dst)

    return local_call(move, mesh, (x,), (pl[0],), pl[1])


# --------------------------------------------------------------------------- #
# Explicit gather/scatter (paper's designated-rank mechanism) for validation
# --------------------------------------------------------------------------- #
def explicit_gather_scatter(mesh, axis: str):
    """Gather→scatter along ``axis``: every rank gathers the full batch then
    keeps its own shard — the Fig. 6 data movement (gather from E_dp groups,
    scatter to L_dp groups) when the two layouts shard the same logical
    batch differently."""

    def fn(x):
        full = all_gather(x, mesh, axis)
        n, idx = axes_size(mesh, axis), axis_index(mesh, axis)
        shard = full.shape[0] // n
        return full[idx * shard:(idx + 1) * shard]

    return fn
