"""Physical plan hot-swap: re-lay-out the training state across ranks for a
re-planned θ*.

`RuntimeController.maybe_swap()` changes the *logical* bucket structure
the Online Scheduler balances against; this module supplies the *physical*
half — without it, the state stays laid out for the stale plan and the
swapped θ* is a fiction.  Three pieces:

  * ``plan_mesh(plan)`` — the ``(data, stage, model)`` mesh a
    `ParallelismPlan`'s LLM parallelism implies, a ``DeviceMesh`` built by
    `launch.mesh.make_mesh` over a prefix of the process group's ranks.
    Building one is a collective: every rank of the group calls the mesh
    factory with the same plan and roster, in the mesh or not.
  * ``reshard_params(params, old_plan, new_plan)`` — re-stack
    stage-stacked leaves for the new PP degree (`executor.stack_stage_params`
    with ``from_p``) and place every leaf on the new mesh, one leaf at a
    time: gather it over the old mesh (point-to-point sends from a rank
    that holds each block to each rank of the new mesh that lacks it),
    restack it, keep this rank's part, and release the old leaf before the
    next — the counterpart of the reference's donated ``device_put``, so
    the state is never resident twice.  Returns the state as a `Placed`
    plus a `ReshardReport` (bytes moved, elapsed seconds, old/new plans).
  * ``ParamSwapper`` — the controller-facing hook: owns get/set callbacks
    into the training loop's live state, estimates transition cost
    (measured history first, bytes/bandwidth model otherwise) so
    `maybe_swap()` can gate a swap on amortized reshard cost, and performs
    the re-layout at the global-batch boundary.

Placement (the reference's ``NamedSharding``) is local tensors plus a
recorded `Layout`: a rank of the new mesh holds its stage's block of each
leaf's leading dim (``spec ("stage",)``) or a full copy (``spec ()``), and a
rank outside it holds an empty tensor of the leaf's dtype — no bytes of
the state.  Byte counts in the report are global, the reference's.

Layout reconfiguration is *not* free (DistTrain, arXiv:2408.04275): the
swap decision must weigh measured/estimated reshard time against the
predicted per-batch makespan advantage over a horizon — the gate lives in
`repro_torch.runtime.controller`, the cost model here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.optimizer.space import ParallelismPlan
from repro_torch.core.pipeline.executor import stack_stage_params
from repro_torch.launch.mesh import make_mesh, mesh_shape

# Axis convention for plan-implied meshes.  `pipeline_forward` takes
# stage-stacked leaves sharded over "stage"; "data"/"model" replicate them.
PLAN_AXES = ("data", "stage", "model")

# Default cost-model constants for `estimate_reshard_s`: the H100 SXM's
# NVLink 4 bandwidth, 450 GB/s each way (NVIDIA's H100 datasheet, 900 GB/s
# bidirectional; the measured-report path replaces it as soon as one real
# swap has happened), and a fixed latency floor per transition.
DEFAULT_BANDWIDTH_BYTES_PER_S = 4.5e11
DEFAULT_LATENCY_S = 5e-3


@dataclass(frozen=True)
class ReshardReport:
    """What one physical swap actually did (trace/metrics payload)."""

    old_plan: tuple                # ParallelismPlan.as_tuple() before
    new_plan: tuple                # ... and after
    bytes_moved: int               # global bytes placed onto a new layout
    bytes_total: int               # global bytes of the state
    elapsed_s: float               # wall time, ending in a device synchronize
    n_leaves: int
    restacked: bool                # stage leaves re-partitioned for new PP


@dataclass(frozen=True)
class Layout:
    """Where placed leaves live: a mesh (axis names, shape, global ranks in
    row-major order) and every leaf's spec — ``("stage",)`` shards the
    leading dim over the mesh's "stage" axis in equal blocks, ``()``
    replicates.  Two layouts are equal when all of these are, as two of
    the reference's ``NamedSharding``s are."""

    axes: tuple
    shape: tuple
    ranks: tuple
    spec: tuple = ()

    @classmethod
    def of(cls, mesh, spec=()) -> "Layout":
        return cls(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.mesh.shape),
                   tuple(int(r) for r in mesh.mesh.flatten().tolist()), tuple(spec))

    def holds(self, rank: int) -> bool:
        return rank in self.ranks

    @property
    def n_blocks(self) -> int:
        """Distinct blocks of a leaf: the stage axis's size when sharded."""
        if self.spec and "stage" in self.axes:
            return self.shape[self.axes.index("stage")]
        return 1

    def block_of(self, rank: int) -> int:
        """The block ``rank`` holds (its coordinate on the stage axis)."""
        if self.n_blocks == 1:
            return 0
        idx, coord = self.ranks.index(rank), []
        for size in reversed(self.shape):
            idx, c = divmod(idx, size)
            coord.append(c)
        return coord[::-1][self.axes.index("stage")]

    def holders(self, block: int) -> list:
        return [r for r in self.ranks if self.block_of(r) == block]

    def rows(self, block: int, n: int) -> tuple:
        """Rows ``[lo, hi)`` of a leading dim of ``n`` in ``block``."""
        k = n // self.n_blocks
        return block * k, (block + 1) * k


class Placed:
    """A state tree laid out on a plan mesh (what `reshard_params` returns).

    ``tree`` holds this rank's part of every leaf: its block of the leading
    dim (``spec == ("stage",)``), a full copy (``()``), or, outside the
    mesh, an empty tensor of the leaf's dtype.  ``shapes``/``dtypes`` give
    each leaf's global shape and dtype in ``tree_leaves`` order (None for a
    leaf that is not a tensor, such as AdamW's step count: ranks of the mesh
    hold its value, others None).  Index it as the tree (``state[0]``) for a
    placed part of it."""

    def __init__(self, like, leaves: list, shapes: list, dtypes: list,
                 layout: Layout, mesh, device):
        self._like, self.leaves = like, leaves
        self.shapes, self.dtypes = shapes, dtypes
        self.layout, self.mesh, self.device = layout, mesh, device

    @property
    def tree(self):
        return tree_unflatten(self._like, self.leaves)

    @property
    def spec(self) -> tuple:
        return self.layout.spec

    def __getitem__(self, key) -> "Placed":
        like = self._like
        keys = sorted(like) if isinstance(like, dict) else range(len(like))
        lo = 0
        for k in keys:
            if k == key:
                break
            lo += len(tree_leaves(like[k]))
        hi = lo + len(tree_leaves(like[key]))
        return Placed(like[key], self.leaves[lo:hi], self.shapes[lo:hi],
                      self.dtypes[lo:hi], self.layout, self.mesh, self.device)

    def with_tree(self, tree) -> "Placed":
        """The same placement holding ``tree``'s leaves (a training step's
        outputs on a rank of the mesh)."""
        leaves = tree_leaves(tree)
        if len(leaves) != len(self.leaves):
            raise ValueError(f"{len(leaves)} leaves for a state of {len(self.leaves)}")
        return Placed(self._like, leaves, self.shapes, self.dtypes, self.layout,
                      self.mesh, self.device)

    @property
    def nbytes(self) -> int:
        """Global bytes of the state."""
        return sum(_nbytes(s, d) for s, d in zip(self.shapes, self.dtypes) if s is not None)

    def local_bytes(self) -> int:
        """Bytes of the state this rank holds."""
        return sum(a.nbytes for a in self.leaves if isinstance(a, torch.Tensor))


def _nbytes(shape, dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * dtype.itemsize


def _group_ranks(ranks) -> list:
    if ranks is not None:
        return list(ranks)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("plan meshes are built over the ranks of an initialised "
                           "process group (torch.distributed.init_process_group)")
    return list(range(dist.get_world_size()))


def plan_mesh(plan: ParallelismPlan, *, ranks=None, device_type: str = "cuda"):
    """Mesh implied by ``plan.llm``: shape (dp, pp, tp), axes PLAN_AXES.

    Uses the first ``dp·pp·tp`` of ``ranks`` (default: every rank of the
    process group); raises ``ValueError`` when the plan needs more ranks
    than exist — `ParamSwapper.compatible` turns that into a gated swap."""
    mp = plan.llm
    n = mp.dp * mp.pp * mp.tp
    ranks = _group_ranks(ranks)
    if n > len(ranks):
        raise ValueError(f"plan {plan.as_tuple()} needs {n} ranks, have {len(ranks)}")
    return make_mesh((mp.dp, mp.pp, mp.tp), PLAN_AXES, ranks=ranks[:n],
                     device_type=device_type)


def clamped_plan_mesh(plan: ParallelismPlan, *, ranks=None, device_type: str = "cuda"):
    """`plan_mesh` clamped onto however many ranks exist.

    Single-host runs fit a pod-scale transition onto the ranks they have:
    each axis is cut to fit (tp first, then pp, then dp), preserving the
    plan's axis *structure* while the rank count shrinks.  Production
    launches use `plan_mesh` unclamped."""
    ranks = _group_ranks(ranks)
    n = len(ranks)
    tp = min(plan.llm.tp, n)
    pp = min(plan.llm.pp, max(n // tp, 1))
    dp = min(plan.llm.dp, max(n // (tp * pp), 1))
    return make_mesh((dp, pp, tp), PLAN_AXES, ranks=ranks[:dp * pp * tp],
                     device_type=device_type)


def param_bytes(params) -> int:
    """Total (global) bytes across a state: a `Placed` or a tree of tensors.

    >>> param_bytes({"w": torch.zeros(4, 8), "b": torch.zeros(8)})
    160
    """
    if isinstance(params, Placed):
        return params.nbytes
    return int(sum(getattr(leaf, "nbytes", 0) for leaf in tree_leaves(params)))


def estimate_reshard_s(n_bytes: int, *,
                       bandwidth_bytes_per_s: float = DEFAULT_BANDWIDTH_BYTES_PER_S,
                       latency_s: float = DEFAULT_LATENCY_S) -> float:
    """Transfer-time estimate for moving ``n_bytes`` to a new layout.

    >>> estimate_reshard_s(2 * 10**9, bandwidth_bytes_per_s=1e11,
    ...                    latency_s=0.0)
    0.02
    """
    return n_bytes / bandwidth_bytes_per_s + latency_s


class _Source:
    """A state to re-lay-out, flattened: leaves, global shapes and dtypes,
    its layout (None: a plain tree, whole on every rank) and where each
    leaf sits, so that a moved leaf can be dropped from its container."""

    def __init__(self, params):
        if isinstance(params, Placed):
            self.placed, self.like, self.leaves = params, params._like, list(params.leaves)
            self.shapes, self.dtypes = params.shapes, params.dtypes
            self.layout, self.device = params.layout, params.device
            return
        self.placed, self.layout = None, None
        self.like = tree_map(lambda _: None, params)
        self.leaves = tree_leaves(params)
        self.shapes = [tuple(a.shape) if isinstance(a, torch.Tensor) else None
                       for a in self.leaves]
        self.dtypes = [a.dtype if isinstance(a, torch.Tensor) else None for a in self.leaves]
        self.device = next((a.device for a in self.leaves if isinstance(a, torch.Tensor)),
                           torch.device("cpu"))
        self.slots = _slots(params, [])       # (container, key) of each leaf

    def release(self, i: int) -> None:
        """Drop the caller's reference to leaf ``i`` (donation)."""
        self.leaves[i] = None
        if self.placed is not None:
            self.placed.leaves[i] = None
            return
        box, key = self.slots[i]
        if box is not None:
            box[key] = None


def _slots(t, out: list) -> list:
    """``(container, key)`` of each leaf of ``t`` in ``tree_leaves`` order;
    ``(None, None)`` where it cannot be dropped (a tuple's item, a bare
    leaf)."""
    if isinstance(t, dict):
        items = [(t, k, t[k]) for k in sorted(t)]
    elif isinstance(t, (list, tuple)):
        items = [(t if isinstance(t, list) else None, i, x) for i, x in enumerate(t)]
    else:
        out.append((None, None))
        return out
    for box, key, x in items:
        if isinstance(x, (dict, list, tuple)):
            _slots(x, out)
        else:
            out.append((box, key))
    return out


def _stage_stacked(shapes, pp: int) -> bool:
    return bool(shapes) and all(s is not None and len(s) >= 2 and s[0] == pp
                                for s in shapes)


def _restackable(shapes, old_pp: int, new_pp: int) -> bool:
    return all((s[0] * s[1]) % new_pp == 0 for s in shapes) \
        if _stage_stacked(shapes, old_pp) else False


def _state_shapes(params) -> list:
    return _Source(params).shapes


def _gather(leaf, shape, dtype, device, old: Optional[Layout], need, me: int):
    """Leaf ``leaf`` (this rank's part under ``old``) whole on every rank of
    ``need``: ``(full or None, whether full is a buffer of its own)``.
    Every rank runs the same loops and takes part in its own sends and
    receives only, in one global order, so blocking point-to-point calls
    cannot deadlock."""
    if old is None:                           # a plain tree: whole everywhere
        return (leaf, False) if me in need else (None, False)
    if old.n_blocks == 1:                     # replicated on old.ranks
        src, full, fresh = old.ranks[0], (leaf if old.holds(me) else None), False
        for d in need:
            if old.holds(d):
                continue
            if me == src:
                dist.send(leaf.contiguous(), d)
            elif me == d:
                full, fresh = torch.empty(shape, dtype=dtype, device=device), True
                dist.recv(full, src)
        return (full if me in need else None), fresh
    full = None
    if me in need:
        full = torch.empty(shape, dtype=dtype, device=device)
        if old.holds(me):
            lo, hi = old.rows(old.block_of(me), shape[0])
            full[lo:hi].copy_(leaf)
    for b in range(old.n_blocks):
        holders = old.holders(b)
        lo, hi = old.rows(b, shape[0])
        for d in need:
            if d in holders:
                continue
            if me == holders[0]:
                dist.send(leaf.contiguous(), d)
            elif me == d:
                dist.recv(full[lo:hi], holders[0])
    return full, full is not None


def _move_object(value, old: Optional[Layout], new: Layout, me: int):
    """A leaf that is not a tensor (a step count): from the old mesh's
    first rank to every rank of the new mesh; None outside it."""
    if old is not None and any(not old.holds(d) for d in new.ranks):
        box = [value]
        dist.broadcast_object_list(box, src=old.ranks[0])
        value = box[0]
    return value if new.holds(me) else None


def reshard_params(params, old_plan: ParallelismPlan,
                   new_plan: ParallelismPlan, *,
                   new_mesh=None,
                   stage_stacked: Optional[bool] = None,
                   donate: bool = True,
                   mesh_factory: Callable = plan_mesh):
    """Re-lay-out ``params`` from ``old_plan``'s layout to ``new_plan``'s.

    ``params`` is a `Placed` (an earlier swap's output) or a plain tree of
    tensors, whole and equal on every rank (a seeded init).  Every rank of
    the process group calls this with the same plans.

    Stage-stacked pipeline params (leaves ``(old_pp, L/old_pp, ...)``) are
    re-partitioned to ``(new_pp, L/new_pp, ...)`` and sharded over the new
    mesh's "stage" axis; generic trees are replicated onto the new mesh.
    A *schedule-only* transition (same LLM parallelism, different schedule
    family in the widened θ tuple) implies an identical mesh: the re-layout
    degenerates to a no-op placement (``bytes_moved == 0``) while the
    report still records the full old/new plan identities.  ``donate``
    drops each old leaf from its container (a `Placed`, a dict or a list)
    once it is moved, so peak memory stays at one copy plus a leaf;
    ``donate=False`` keeps the input whole (a recoverable swap, at the
    price of a second copy).

    Returns ``(new_params, ReshardReport)``, ``new_params`` a `Placed`.
    """
    return _reshard(params, old_plan, new_plan, new_mesh, stage_stacked, donate,
                    mesh_factory, {"released": 0})


def _reshard(params, old_plan, new_plan, new_mesh, stage_stacked, donate,
             mesh_factory, progress):
    t0 = time.monotonic()
    src = _Source(params)
    old_pp, new_pp = old_plan.llm.pp, new_plan.llm.pp
    if stage_stacked is None:
        # Every leaf shaped (old_pp, layers, ...) reads as stage-stacked —
        # including old_pp == 1, where a (1, L, ...) tree must still be
        # re-partitioned for a larger new PP.  The heuristic is ambiguous
        # for generic trees whose leaves all happen to lead with old_pp;
        # pass stage_stacked explicitly (ParamSwapper always does) when
        # the layout is known.
        stage_stacked = _stage_stacked(src.shapes, old_pp)

    restacked = False
    if stage_stacked and old_pp != new_pp:
        if not _restackable(src.shapes, old_pp, new_pp):
            raise ValueError(
                f"cannot re-stack stage params from pp={old_pp} to "
                f"pp={new_pp}: layer count not divisible")
        restacked = True

    if new_mesh is None:
        new_mesh = mesh_factory(new_plan)

    # Stage leaves shard over "stage" only when their leading dim divides
    # the mesh's actual stage-axis size — a clamped mesh can be narrower
    # than the plan's PP (e.g. pp=7 on 4 ranks), where the correct layout
    # is replication, not a failure.
    spec = ()
    if stage_stacked:
        # leading dim is new_pp here: a pp change either restacks or raised
        stage_size = mesh_shape(new_mesh).get("stage", 1)
        if new_pp % stage_size == 0:
            spec = ("stage",)
    layout = Layout.of(new_mesh, spec)

    shapes = [s if s is None or not restacked
              else (new_pp, s[0] * s[1] // new_pp, *s[2:]) for s in src.shapes]
    total = sum(_nbytes(s, d) for s, d in zip(src.shapes, src.dtypes) if s is not None)
    moved = total if restacked or src.layout != layout else 0

    me = dist.get_rank()
    leaves = []
    # by index: zip and enumerate keep their last result tuple, and with it
    # an old leaf, alive into the next leaf's copy
    for i in range(len(src.leaves)):
        leaf, shape, dtype = src.leaves[i], src.shapes[i], src.dtypes[i]
        if shape is None:
            leaves.append(_move_object(leaf, src.layout, layout, me))
            continue
        if not moved:
            leaves.append(leaf)
            continue
        # a trainable leaf stays one (every rank's local leaf, an empty one
        # outside the mesh too, carries the flag)
        grad = leaf.requires_grad
        with torch.no_grad():
            full, fresh = _gather(leaf, shape, dtype, src.device, src.layout,
                                  layout.ranks, me)
            del leaf
            if donate:
                src.release(i)
                progress["released"] += 1
            if full is None:
                new = torch.empty(0, dtype=dtype, device=src.device)
            else:
                if restacked:
                    full = stack_stage_params(full, new_pp, from_p=old_pp)
                new = full
                if layout.n_blocks > 1:
                    lo, hi = layout.rows(layout.block_of(me), full.shape[0])
                    new, fresh = full[lo:hi], fresh and (lo, hi) == (0, full.shape[0])
                new = new.detach() if fresh else new.clone(memory_format=torch.contiguous_format)
                del full
        leaves.append(new.requires_grad_(grad))
        del new
    if src.device.type == "cuda":
        torch.cuda.synchronize(src.device)

    report = ReshardReport(
        old_plan=old_plan.as_tuple(), new_plan=new_plan.as_tuple(),
        bytes_moved=moved, bytes_total=total,
        elapsed_s=time.monotonic() - t0, n_leaves=len(src.leaves),
        restacked=restacked)
    return Placed(src.like, leaves, shapes, src.dtypes, layout, new_mesh, src.device), report


class ParamSwapper:
    """Controller hook performing the physical half of a plan hot-swap.

    The training loop owns the live state; the swapper reaches it through
    ``get_params``/``set_params`` callbacks so a swap at the global-batch
    boundary replaces the loop's state:

        state = {"params": params}
        swapper = ParamSwapper(lambda: state["params"],
                               lambda p: state.update(params=p))
        ctl = engine.runtime(gbs, param_swapper=swapper)

    Every rank of the process group makes the same swapper calls
    (``compatible``, ``swap``, ``refresh``) in the same order: each builds a
    mesh, a collective.  ``stage_stacked=True`` declares pipeline-stacked
    leaves (re-partitioned across PP transitions; with ``strict=True`` an
    impossible re-stack makes `compatible()` False, which gates the *whole*
    swap — the logical and physical plans never diverge).  ``strict=False``
    (emulation mode) falls back to a plain re-placement when the layer
    count doesn't divide the new PP.
    """

    def __init__(self, get_params: Callable[[], object],
                 set_params: Callable[[object], None], *,
                 stage_stacked: bool = False,
                 strict: bool = True,
                 donate: bool = True,
                 mesh_factory: Callable = plan_mesh,
                 bandwidth_bytes_per_s: float = DEFAULT_BANDWIDTH_BYTES_PER_S,
                 latency_s: float = DEFAULT_LATENCY_S):
        self._get = get_params
        self._set = set_params
        self.stage_stacked = stage_stacked
        self.strict = strict
        self.donate = donate
        self.mesh_factory = mesh_factory
        self.bandwidth_bytes_per_s = bandwidth_bytes_per_s
        self.latency_s = latency_s
        self.reports: List[ReshardReport] = []
        # True once a failed swap has already released old leaves: the
        # stale layout is gone too, recovery is impossible, and the
        # controller must fail fast instead of training on a partial
        # state.  Pass donate=False for a fully recoverable swap at the
        # price of transient double-residency.
        self.damaged = False

    # ------------------------------------------------------------------ #
    def compatible(self, old_plan: ParallelismPlan,
                   new_plan: ParallelismPlan) -> bool:
        """Can this transition be realized physically?  A False return
        gates the logical swap too (controller policy)."""
        try:
            self.mesh_factory(new_plan)
        except ValueError:
            return False
        if (self.strict and self.stage_stacked
                and old_plan.llm.pp != new_plan.llm.pp):
            return _restackable(_state_shapes(self._get()), old_plan.llm.pp,
                                new_plan.llm.pp)
        return True

    def estimate_cost_s(self, old_plan: ParallelismPlan,
                        new_plan: ParallelismPlan) -> float:
        """Predicted reshard wall time for the amortization gate.

        Always sized to the bytes of the transition being priced: once any
        swap has moved real bytes, the configured bandwidth is replaced by
        the *measured* one (Σbytes/Σelapsed over history) — a raw mean of
        past elapsed times would misprice as soon as transitions of
        different magnitudes mix."""
        n_bytes = param_bytes(self._get())
        informative = [(r.bytes_moved, r.elapsed_s) for r in self.reports
                       if r.bytes_moved > 0 and r.elapsed_s > 0]
        bandwidth = self.bandwidth_bytes_per_s
        if informative:
            bandwidth = (sum(b for b, _ in informative)
                         / sum(t for _, t in informative))
        return estimate_reshard_s(n_bytes, bandwidth_bytes_per_s=bandwidth,
                                  latency_s=self.latency_s)

    # ------------------------------------------------------------------ #
    def swap(self, old_plan: ParallelismPlan,
             new_plan: ParallelismPlan) -> ReshardReport:
        params = self._get()
        stacked = self.stage_stacked
        if (stacked and not self.strict
                and not _restackable(_state_shapes(params), old_plan.llm.pp,
                                     new_plan.llm.pp)):
            stacked = False          # emulation fallback: re-place only
        progress = {"released": 0}
        try:
            new_params, report = _reshard(params, old_plan, new_plan, None, stacked,
                                          self.donate, self.mesh_factory, progress)
        except Exception:
            if progress["released"]:
                self.damaged = True
            raise
        self._set(new_params)
        self.reports.append(report)
        return report

    def refresh(self, plan: ParallelismPlan) -> ReshardReport:
        """Re-place the *same* logical plan onto whatever mesh
        ``mesh_factory`` currently resolves — the elastic-recovery
        primitive: after a host loss, a fleet-backed factory
        (`FleetManager.plan_mesh`) now maps the plan onto the surviving
        ranks, so ``refresh`` migrates the live state off the dead host
        without a plan change (and without a checkpoint); after a join it
        brings the state back to the rejoined ranks."""
        return self.swap(plan, plan)

    __call__ = swap
