"""Op-level statistics of one step: the port's counterpart of the
reference's HLO analyzer (``repro/launch/hlo_stats.py``).

The reference parses the compiled, per-device HLO module; an eager torch
step has no such text.  ``Recorder`` is a ``TorchDispatchMode`` that sees
every aten op the step runs on this rank's tensors and accumulates the same
``HloStats``:

  * ``flops``            — torch's FLOP formulas (``torch.utils.flop_counter``:
                           matmuls, convolutions, attention) plus those the
                           kernels K1–K7 register for their ops, applied to
                           the shapes the rank computes on.  On a DTensor the
                           mode declines the op, DTensor runs it as local ops
                           on each rank's shards, and the mode counts those:
                           a DTensor's FLOPs are its local tensors', not the
                           global shape's.
  * ``hbm_bytes``        — Σ (operand + result bytes) of every op that moves
                           data; views, metadata and allocations are skipped,
                           the counterpart of the reference's
                           ``_SKIP_BYTES_OPS``.  An eager op crosses HBM as a
                           fused XLA op does, so unfused elementwise chains
                           count each link.
  * ``collective_bytes`` — Σ operand bytes of the collectives, by the
    ``collective_counts``  reference's kinds: DTensor's redistributions
                           (functional collectives) and the port's explicit
                           c10d calls (``common/collectives.py``,
                           ``core/communicator.py``, ``sharding/vocab_ce.py``);
                           on a fake process group the calls move nothing and
                           the recorder reads their operand sizes.
  * ``while_trips``      — eager loops run every trip, so no count needs a
                           trip-count correction; the caller records the
                           loops it ran (layers, microbatches) with
                           ``note_loop`` under this key.

DTensor computes each op's global output shape by running it on global-shape
fake tensors (its sharding propagation).  Those runs are no part of a rank's
work: ``muted_propagation`` marks them, and the recorder (and the dry run's
memory tracker) skip what runs under the mark.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int16: 2,
    torch.int32: 4, torch.int64: 8, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.bfloat16: 2, torch.float16: 2,
    torch.float32: 4, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def shape_bytes(shape, dtype) -> int:
    """Bytes of a tensor of ``shape`` (a sequence of ints) and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * DTYPE_BYTES[dtype]


def tensor_bytes(t) -> int:
    """Bytes of a tensor's elements (a DTensor's local shard)."""
    t = getattr(t, "_local_tensor", t)
    return shape_bytes(t.shape, t.dtype)


@dataclass
class HloStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    while_trips: Dict[str, int] = field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "total_collective_bytes": self.total_collective_bytes,
            "while_trips": self.while_trips,
        }


# --------------------------------------------------------------------------- #
# DTensor's shape propagation, marked
# --------------------------------------------------------------------------- #
_MUTED = [0]


def muted() -> bool:
    """True while DTensor propagates shapes (see the module doc)."""
    return _MUTED[0] > 0


@contextlib.contextmanager
def muted_propagation():
    """Mark DTensor's shape-propagation runs for as long as this is open."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    inner = prop._propagate_tensor_meta_non_cached

    def marked(op_schema):
        _MUTED[0] += 1
        try:
            return inner(op_schema)
        finally:
            _MUTED[0] -= 1

    prop._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        del prop._propagate_tensor_meta_non_cached     # the class's again


# --------------------------------------------------------------------------- #
# Op tables
# --------------------------------------------------------------------------- #
def _ops(ns, *names):
    out = set()
    for name in names:
        base, _, overload = name.partition(".")
        packet = getattr(ns, base, None)
        if packet is not None and hasattr(packet, overload or "default"):
            out.add(getattr(packet, overload or "default"))
    return out


_aten, _prims = torch.ops.aten, torch.ops.prim
_c10d, _funcol = torch.ops.c10d, torch.ops._c10d_functional

# allocations, metadata and copies-free bookkeeping: no bytes cross HBM
_SKIP_BYTES_OPS = _ops(
    _aten, "empty.memory_format", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "detach", "lift_fresh", "_local_scalar_dense",
    "sym_size.int", "sym_stride.int", "sym_numel", "sym_storage_offset",
    "is_same_size", "alias",
) | _ops(_prims, "device")

# (op, kind, index of the operand the bytes are read from)
_COLLECTIVE_OPS = {}
for _kind, _ns, _names, _arg in (
        ("all-reduce", _funcol, ("all_reduce", "all_reduce_"), 0),
        ("all-reduce", _c10d, ("allreduce_",), 0),
        ("all-gather", _funcol, ("all_gather_into_tensor",), 0),
        ("all-gather", _c10d, ("_allgather_base_",), 1),
        ("all-gather", _c10d, ("allgather_",), 1),
        ("reduce-scatter", _funcol, ("reduce_scatter_tensor",), 0),
        ("reduce-scatter", _c10d, ("_reduce_scatter_base_",), 1),
        ("reduce-scatter", _c10d, ("reduce_scatter_",), 1),
        ("all-to-all", _funcol, ("all_to_all_single",), 0),
        ("all-to-all", _c10d, ("alltoall_base_",), 1),
        ("all-to-all", _c10d, ("alltoall_",), 1),
        ("collective-permute", _c10d, ("send",), 0),
        ("collective-permute", _c10d, ("recv_",), 0),
        ("broadcast", _c10d, ("broadcast_",), 0),
        ("broadcast", _funcol, ("broadcast",), 0)):
    for _op in _ops(_ns, *_names):
        _COLLECTIVE_OPS[_op] = (_kind, _arg)


def _all_tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _all_tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _all_tensors(y)


class Recorder(TorchDispatchMode):
    """Accumulates ``HloStats`` over the ops run while it is entered (see
    the module doc).  ``stats`` holds them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        # the kernels' formulas register when their modules import
        import repro_torch.kernels.ops  # noqa: F401
        self._flops = flop_registry
        self.stats = HloStats()

    def note_loop(self, name: str, trips: int) -> None:
        self.stats.while_trips[name] = int(trips)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # count the local ops DTensor runs
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not muted():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        st = self.stats
        formula = self._flops.get(func._overloadpacket)
        if formula is not None:
            st.flops += float(formula(*args, **kwargs, out_val=out))
        coll = _COLLECTIVE_OPS.get(func)
        if coll is not None:
            kind, i = coll
            operand = args[i] if i < len(args) else out
            st.collective_bytes[kind] += float(sum(
                tensor_bytes(t) for t in _all_tensors(operand)))
            st.collective_counts[kind] += 1
        if func in _SKIP_BYTES_OPS or func.is_view:
            return
        st.hbm_bytes += float(sum(tensor_bytes(t) for t in _all_tensors(args))
                              + sum(tensor_bytes(t) for t in _all_tensors(out)))


def analyze(fn, *args, **kwargs) -> HloStats:
    """``HloStats`` of one call of ``fn(*args, **kwargs)``."""
    rec = Recorder()
    with muted_propagation(), rec:
        fn(*args, **kwargs)
    return rec.stats
