"""Per-rank code on DTensors: ``local_map`` at the reference's ``shard_map``
specs.

The port's sharded paths (the expert-parallel and TP-expert MoE, the
vocab-parallel CE, the communicator) and the kernels are written for one
rank's local tensors with explicit collectives.  On DTensors (the dry run,
``launch/dryrun.py``) each runs inside ``torch.distributed.tensor.
experimental.local_map``, the torch counterpart of ``shard_map``: inputs are
redistributed to the given specs, the function sees each rank's shards,
and outputs come back as DTensors with the given placements.

Gradients: a rank's gradient of an input it holds replicated over an axis
is, in this code's convention, only its own share where the ranks of that
axis each used it for different rows or channels; ``grad_partial`` names
those axes, and the gradient comes back ``Partial`` over them (DTensor sums
it where a later op needs it, as ``shard_map``'s transpose psums).
"""
from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.launch.mesh import mesh_shape
from repro_torch.sharding.partition import P, sanitize_spec, to_placements


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def axes_of(x, dim: int) -> tuple:
    """Names of the mesh axes that shard ``dim`` of DTensor ``x``, in mesh
    order."""
    from torch.distributed.tensor import Shard
    names = x.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(x.placements) if p == Shard(dim))


def placements(mesh, spec: P, shape) -> list:
    """DTensor placements of ``spec`` sanitised for ``shape`` (a list: one
    output's placements, as ``local_map`` reads them)."""
    return list(to_placements(sanitize_spec(spec, tuple(shape), mesh), mesh))


def partial_over(pl: Sequence, mesh, axes) -> list:
    """``pl`` with ``Partial()`` on each of ``axes`` it replicates."""
    from torch.distributed.tensor import Partial, Replicate
    names = list(mesh_shape(mesh))
    axes = set((axes,) if isinstance(axes, str) else axes or ())
    return [Partial() if names[i] in axes and p == Replicate() else p
            for i, p in enumerate(pl)]


def local_call(fn: Callable, mesh, args: Sequence, in_pl: Sequence,
               out_pl, grad_pl: Sequence | None = None):
    """``fn(*local args)`` on each rank's shards of ``args`` placed as
    ``in_pl`` (``None`` for a non-tensor argument); the output placed as
    ``out_pl`` (a list), or several as a tuple of lists; input gradients as
    ``grad_pl`` (default ``in_pl``).  A plain tensor among ``args`` is taken
    as replicated (as under ``implicit_replication``)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    args = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
            if isinstance(a, torch.Tensor) and not is_dtensor(a) and pl is not None
            else a for a, pl in zip(args, in_pl)]
    wrapped = local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                        in_grad_placements=tuple(grad_pl or in_pl),
                        device_mesh=mesh, redistribute_inputs=True)
    return wrapped(*args)


def rows_local(fn: Callable, rows: Sequence, whole: Sequence, out_ndim: int):
    """``fn(*rows, *whole)`` on each rank's rows: the ``rows`` tensors (and
    the output, of ``out_ndim`` dims) with dim 0 over the axes that shard the
    first one's dim 0, the ``whole`` tensors replicated (their gradients
    partial over those axes).  Per-row code with no collective, kept off
    DTensor's own op rules."""
    mesh = rows[0].device_mesh
    b = axes_of(rows[0], 0) or None
    row_pl = [placements(mesh, P(b, *(None,) * (t.ndim - 1)), t.shape) for t in rows]
    whole_pl = [placements(mesh, P(), t.shape) for t in whole]
    out_pl = placements(mesh, P(b, *(None,) * (out_ndim - 1)),
                        (rows[0].shape[0],) + (1,) * (out_ndim - 1))
    return local_call(fn, mesh, (*rows, *whole), (*row_pl, *whole_pl), out_pl,
                      (*row_pl, *(partial_over(p, mesh, b) for p in whole_pl)))
