"""Collectives over named mesh axes, with the backward rules JAX gives them
under ``shard_map``.

Convention: a tensor *replicated* over an axis holds, on every rank of it,
the same value, and after a backward the same *full* gradient (as a JAX
array does whatever its sharding).  So:

* ``sum_over`` — a sum over ranks whose result every rank then uses the
  same way: forward all-reduce, backward **identity** (each rank's partial
  receives the full cotangent of the sum).  ``torch.distributed.nn``'s
  all-reduce all-reduces the cotangent as well, which would make every
  gradient p times too large.
* ``grad_sum_over`` — an input taken replicated over an axis whose ranks
  each use it for a different part of the work: forward identity, backward
  all-reduce (Megatron's "f").
* ``all_gather`` — tiled gather along a dim; backward reduce-scatter (for
  a gathered tensor whose ranks each use a different part of it).
* ``split_over`` / ``gather_over`` — Megatron's pair for a replicated
  activation that each rank works on a slice of: ``split_over`` keeps this
  rank's chunk of a dim (backward all-gathers the chunks' gradients, so the
  replicated input gets its full gradient); ``gather_over`` all-gathers the
  chunks back into the replicated tensor (backward keeps this rank's chunk of
  the full cotangent every rank holds; a reduce-scatter would count it once a
  rank).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; ``axes`` is an
axis name or a tuple of names (major to minor).  Collectives over several
axes run one axis at a time.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_size


def as_axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes) -> int:
    """This rank's linear index over ``axes``, the first one major."""
    i = 0
    for a in as_axes(axes):
        i = i * axes_size(mesh, a) + mesh.get_local_rank(a)
    return i


def _all_reduce(x, mesh, axes, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    for a in as_axes(axes):
        dist.all_reduce(x, op=op, group=mesh.get_group(a))
    return x


def _gather(x, mesh, axis, dim):
    group = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _gather_axes(x, mesh, axes, dim):
    """Tiled gather over several axes in rank order (the first major): the
    minor axis first, so each step joins contiguous blocks."""
    for a in reversed(as_axes(axes)):
        x = _gather(x, mesh, a, dim)
    return x


def _chunk(x, mesh, axes, dim):
    """This rank's chunk of ``dim`` over ``axes`` (its linear index)."""
    n = axes_size(mesh, as_axes(axes))
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} ranks of {as_axes(axes)}")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


def _scatter_sum(g, mesh, axis, dim):
    """Reduce-scatter: the sum over ``axis`` of ``g``, this rank's chunk of
    ``dim`` (all-reduce, then slice: gloo has no reduce-scatter)."""
    n = axes_size(mesh, axis)
    full = _all_reduce(g, mesh, axis)
    return full.chunk(n, dim)[mesh.get_local_rank(axis)].contiguous()


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradSumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _SplitOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _chunk(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_axes(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather_axes(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None, None, None


def sum_over(x, mesh, axes):
    """All-reduce sum over ``axes``; backward identity (see module doc)."""
    return _SumOver.apply(x, mesh, as_axes(axes))


def grad_sum_over(x, mesh, axes):
    """Identity; backward all-reduces the gradient over ``axes``."""
    return _GradSumOver.apply(x, mesh, as_axes(axes))


def max_over(x, mesh, axes):
    """Elementwise max over ``axes``, no gradient (a stabiliser: the
    reference all-gathers the maxima and reduces them locally)."""
    return _all_reduce(x.detach(), mesh, axes, op=dist.ReduceOp.MAX)


def all_gather(x, mesh, axis: str, dim: int = 0):
    """Tiled all-gather along ``dim`` over ``axis`` (rank order); backward
    reduce-scatter, the transpose ``shard_map`` gives ``all_gather``."""
    return _AllGather.apply(x, mesh, axis, dim)


def split_over(x, mesh, axes, dim: int):
    """This rank's chunk of ``dim`` of a tensor replicated over ``axes``;
    backward all-gathers the chunks' gradients (see module doc)."""
    return _SplitOver.apply(x, mesh, as_axes(axes), dim % x.ndim)


def gather_over(x, mesh, axes, dim: int):
    """The ranks' chunks of ``dim`` joined in rank order over ``axes``, the
    result replicated; backward keeps this rank's chunk (see module doc)."""
    return _GatherOver.apply(x, mesh, as_axes(axes), dim % x.ndim)
