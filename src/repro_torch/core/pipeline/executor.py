"""Pipeline executor: layers split over a ``stage`` mesh axis, microbatches
passed from stage to stage by point-to-point sends.

T = m + p − 1 ticks (the circular-pipeline idiom): at tick t stage 0 takes
microbatch min(t, m − 1), every stage runs its layers and sends its output
to stage (i + 1) mod p (``dist.batch_isend_irecv``), and the last stage
writes output t − (p − 1).  The outputs are then summed over the stage
group (the other stages hold zeros), so every rank returns all m.  The
steady-state bubble matches 1F1B's (p − 1)/(m + p − 1); the discrete-event
simulator (``simulator.py``) models the full 1F1B order for schedule
studies, while this executor runs the pipeline, differentiably.

Stage i at tick t works on microbatch t − i; on a tick where that lies
outside [0, m) its input is a bubble, whose values never reach an output
(stage i's output moves on to stage i + 1 at tick t + 1, another bubble,
and the last stage writes only valid microbatches), so the stage skips its
compute and sends zeros.

Backward (one ``torch.autograd.Function`` over the whole loop, so that
every rank makes the same sends in the same order): the transposes JAX
gives ``shard_map``'s collectives.  The ticks run in reverse; each stage
recomputes its forward from the input it saved (checkpointing inside
``stage_fn`` still applies) and back-propagates the cotangent of its
output: the output's own (last stage) plus what stage i + 1 sends back,
the ring permute the other way round.  The output sum's backward is the
identity (every rank uses the same outputs); the microbatches, taken
replicated over the stage axis, sum their gradient over it.

Homogeneous stages (equal layers per stage, leaves stacked with leading
dims (p, layers_per_stage)).  At p = 1 the ring permute is the identity and
nothing is sent.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.common.collectives import _all_reduce
from repro_torch.launch.mesh import axes_size
from repro_torch.common.pytree import tree_leaves, tree_map, tree_unflatten


def build_stage_fn(layer_apply: Callable, layers_per_stage: int) -> Callable:
    """stage_fn(stage_params, x, *side) applying `layers_per_stage` stacked
    layers, ``layer_apply(layer_params, x, *side)`` each.

    `stage_params` leaves have leading dim layers_per_stage; ``side`` holds
    a microbatch's other inputs (positions, segment ids)."""

    def stage_fn(stage_params, x, *side):
        for i in range(layers_per_stage):
            x = layer_apply(tree_map(lambda a: a[i], stage_params), x, *side)
        return x

    return stage_fn


def _ring(x, mesh, axis: str, shift: int):
    """Send ``x`` to the stage ``shift`` ahead (mod p); receive from the one
    ``shift`` behind."""
    group = mesh.get_group(axis)
    p, i = axes_size(mesh, axis), mesh.get_local_rank(axis)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (i + shift) % p), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (i - shift) % p), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, mbs, *leaves):
        stage_fn, like, side, mesh, axis = run
        p, idx = axes_size(mesh, axis), mesh.get_local_rank(axis)
        m = mbs.shape[0]
        params = tree_unflatten(like, leaves)
        outputs = torch.zeros_like(mbs)
        state = torch.zeros_like(mbs[0])
        saved = {}
        for t in range(m + p - 1):
            j = t - idx                               # this stage's microbatch
            x = mbs[min(t, m - 1)] if idx == 0 else state
            if 0 <= j < m:
                saved[t] = x
                y = stage_fn(params, x, *(s[j] for s in side))
                if idx == p - 1:
                    outputs[j] = y
            else:
                y = torch.zeros_like(x)
            if p > 1 and t < m + p - 2:
                state = _ring(y, mesh, axis, 1)
        ctx.run, ctx.saved, ctx.m = run, saved, m
        ctx.save_for_backward(*leaves)
        return _all_reduce(outputs, mesh, axis)

    @staticmethod
    def backward(ctx, g_out):
        stage_fn, like, side, mesh, axis = ctx.run
        p, idx = axes_size(mesh, axis), mesh.get_local_rank(axis)
        m = ctx.m
        leaves = ctx.saved_tensors
        want = list(ctx.needs_input_grad[2:])
        g_leaves = [torch.zeros_like(a) if w else None for a, w in zip(leaves, want)]
        g_mbs = torch.zeros_like(g_out)
        g_state = None                       # cotangent of this stage's input
        for t in reversed(range(m + p - 1)):
            j = t - idx
            if p > 1 and t < m + p - 2:
                g_y = _ring(g_state, mesh, axis, -1)
            else:
                g_y = torch.zeros_like(g_out[0])
            if idx == p - 1 and 0 <= j < m:
                g_y = g_y + g_out[j]
            if not 0 <= j < m:
                g_state = torch.zeros_like(g_y)
                continue
            with torch.enable_grad():
                x = ctx.saved[t].detach().requires_grad_(True)
                lp = [a.detach().requires_grad_(w) for a, w in zip(leaves, want)]
                y = stage_fn(tree_unflatten(like, lp), x, *(s[j] for s in side))
                wrt = [x] + [a for a, w in zip(lp, want) if w]
                grads = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
            g_x, rest = grads[0], iter(grads[1:])
            g_x = torch.zeros_like(x) if g_x is None else g_x
            for k, w in enumerate(want):
                if w:
                    g = next(rest)
                    if g is not None:
                        g_leaves[k] += g
            if idx == 0:
                g_mbs[j] += g_x
                g_state = torch.zeros_like(g_x)
            else:
                g_state = g_x
        del ctx.saved
        return (None, _all_reduce(g_mbs, mesh, axis), *g_leaves)


def pipeline_forward(mesh, stage_fn: Callable, axis: str = "stage"):
    """Returns f(stacked_stage_params, microbatches, *side) -> outputs.

    stacked_stage_params: leaves (p, layers_per_stage, ...), every stage's;
    this rank takes its own, ``[index on axis]``.  Or a placed state
    (``repro_torch.launch.reshard.Placed``): leaves (pp, L/pp, ...) in p
    blocks over the mesh's stage axis, this rank's block local (its pp/p
    plan stages run as one stage of L/p layers).  microbatches: (m, mb, seq, d), the
    same on every rank of the axis.  side: tensors (m, ...) given to
    ``stage_fn`` a microbatch at a time (positions, segment ids; no
    gradient).  outputs: (m, mb, seq, d) on every rank.
    """
    p = axes_size(mesh, axis)

    def f(stacked_stage_params, microbatches, *side):
        from repro_torch.launch.reshard import Placed
        idx = mesh.get_local_rank(axis)

        def own(a):
            if a.shape[0] != p:
                raise ValueError(f"leaf of leading dim {a.shape[0]} on {p} stages")
            return a[idx]

        if isinstance(stacked_stage_params, Placed):
            local = _placed_stage(stacked_stage_params, p, idx)
        else:
            local = tree_map(own, stacked_stage_params)
        run = (stage_fn, local, side, mesh, axis)
        return _Pipeline.apply(run, microbatches, *tree_leaves(local))

    return f


def _placed_stage(placed, p: int, idx: int):
    """Stage ``idx`` of ``p``'s layers of a placed state: this rank's block,
    (pp/p, L/pp, ...) leaves flattened to (L/p, ...)."""
    lay, me = placed.layout, dist.get_rank()
    if not lay.holds(me) or lay.n_blocks != p or lay.block_of(me) != idx:
        raise ValueError(f"this rank's part of the placed state is not stage {idx} "
                         f"of {p} (layout {lay})")
    return tree_map(lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]),
                    placed.tree)


def stack_layers(layers):
    """The port's per-layer dicts (``params["layers"]``, all of one
    structure) -> leaves stacked (n_layers, ...), the reference's layout
    under ``blocks/pos0`` for a stack of one block period."""
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def stack_stage_params(per_layer_params, p: int, *, from_p=None):
    """(n_layers, ...) stacked layer params -> (p, n_layers/p, ...).

    With ``from_p`` set (any integer, including 1) the leaves are already
    stage-stacked as (from_p, n_layers/from_p, ...) and are re-partitioned
    for the new stage count — the layout transition a physical plan
    hot-swap needs."""

    def reshape(a):
        if from_p is not None:
            if a.shape[0] != from_p:
                raise ValueError(f"leaf leading dim {a.shape[0]} != from_p={from_p}")
            a = a.reshape(from_p * a.shape[1], *a.shape[2:])
        n = a.shape[0]
        if n % p:
            raise ValueError(f"{n} layers not divisible by {p} stages")
        return a.reshape(p, n // p, *a.shape[1:])

    return tree_map(reshape, per_layer_params)


def unstack_stage_params(stacked_params):
    """(p, n_layers/p, ...) stage-stacked leaves -> flat (n_layers, ...)."""
    return tree_map(lambda a: a.reshape(a.shape[0] * a.shape[1], *a.shape[2:]),
                    stacked_params)
