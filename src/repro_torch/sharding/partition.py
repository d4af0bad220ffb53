"""Logical-axis sharding: per-module axis assignments -> PartitionSpecs.

DFLOP's "independent 3D parallelism per module" (paper §4): each module
(modality encoder vs. LLM) gets its own *axis assignment* — which mesh axes
shard the batch dimension and which shard tensor dimensions (heads / ffn /
experts / vocab).  The Data-aware 3D Parallelism Optimizer searches over
these assignments; the Inter-model Communicator
(``repro_torch.core.communicator``) moves activations between them.

Example (mesh ("data","model") = (16,16)):
    encoder: AxisAssignment(batch=("data","model"), tensor=())   # E_dp=256, E_tp=1
    llm:     AxisAssignment(batch=("data",), tensor=("model",))  # L_dp=16,  L_tp=16

The rules are the reference's, entry for entry.  Two things differ in form:

* ``PartitionSpec`` is the port's own: a sequence of entries, each ``None``,
  an axis name or a tuple of axis names, as in the reference.
  ``to_placements`` turns one into DTensor ``Shard``/``Replicate``
  placements on a ``DeviceMesh``.
* The port's params hold one dict a layer (``layers/{i}/...``) where the
  reference stacks ``blocks/pos{j}`` leaves with a leading ``n_blocks`` dim,
  so a port leaf's spec is the reference's with that leading entry dropped.
  With FSDP on, the reference's ``_with_zero`` may put the ZeRO axes on the
  stacked dim itself; a per-layer leaf has no such dim and takes the ZeRO
  axes on its own largest free dim that they divide (ROADMAP Queue 3).

Mesh sizes are read through ``mesh_shape``: a ``DeviceMesh`` or any object
with a ``.shape`` mapping of axis name to size.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.common.pytree import tree_map_with_path_str, tree_paths
from repro_torch.launch.mesh import axes_size, mesh_shape


class PartitionSpec:
    """How a tensor's dims map onto mesh axes: one entry a dim (``None``, an
    axis name, or a tuple of axis names sharding that dim major to minor);
    dims past the last entry are replicated."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


@dataclass(frozen=True)
class AxisAssignment:
    """Mesh-axis roles for one module."""

    batch: Tuple[str, ...] = ("data",)
    tensor: Tuple[str, ...] = ("model",)
    # Optional ZeRO axes: optimizer state (and, with fsdp=True, params) get an
    # extra sharding over these axes on their largest replicated dim.
    zero: Tuple[str, ...] = ()
    fsdp: bool = False
    # path regexes kept OUT of FSDP (resident, tensor-sharded only); vocab
    # tables are always excluded (see param_specs)
    fsdp_exclude: Tuple[str, ...] = ()

    def dp(self, mesh) -> int:
        return axes_size(mesh, tuple(self.batch))

    def tp(self, mesh) -> int:
        return axes_size(mesh, tuple(self.tensor))


@dataclass(frozen=True)
class ModuleAssignment:
    """Per-module assignments for an MLLM (encoder may differ from LLM)."""

    llm: AxisAssignment
    encoder: Optional[AxisAssignment] = None

    def for_module(self, module: str) -> AxisAssignment:
        if module == "encoder" and self.encoder is not None:
            return self.encoder
        return self.llm


# --------------------------------------------------------------------------- #
# Spec sanitation
# --------------------------------------------------------------------------- #
def sanitize_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """Drop shardings that do not divide the dim (replicate instead)."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        size = axes_size(mesh, entry)
        if size > 1 and (i >= len(shape) or shape[i] % size != 0):
            # keep the LARGEST contiguous subsequence of the axes tuple that
            # still divides the dim (e.g. batch 16 over ("pod","data")=(2,16)
            # must keep ("data",)=16, not the ("pod",)=2 prefix)
            if isinstance(entry, tuple):
                best, best_size = None, 1
                n_ax = len(entry)
                for lo in range(n_ax):
                    for hi in range(lo + 1, n_ax + 1):
                        sub = entry[lo:hi]
                        ssize = axes_size(mesh, sub)
                        if shape[i] % ssize == 0 and ssize > best_size:
                            best, best_size = sub, ssize
                out.append(best)
            else:
                out.append(None)
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def to_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: one a mesh axis, in the
    mesh's axis order, ``Shard(dim)`` for an axis that shards tensor dim
    ``dim`` and ``Replicate()`` for the rest.  DTensor shards a dim over its
    mesh axes in the mesh's order, so a dim's axes tuple must list them in
    that order (raises otherwise)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_shape(mesh))
    dim_of = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [order.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"dim {i} of {spec} lists mesh axes {axes} out of "
                             f"the mesh's order {tuple(order)}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            dim_of[a] = i
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in order]


def named(mesh, spec: P) -> list:
    """The reference's ``NamedSharding(mesh, spec)``: ``spec``'s placements."""
    return to_placements(spec, mesh)


# --------------------------------------------------------------------------- #
# Parameter rules (path-pattern based, maxtext-style)
# --------------------------------------------------------------------------- #
# Each rule: (regex on param path, the spec as a function of the assignment).
# Specs are written for one layer's shape; `param_specs` aligns them to the
# trailing dims of the leaf.
def _t(a: AxisAssignment):
    return a.tensor if a.tensor else None


_RULES = [
    # embeddings / unembedding: shard vocab over tensor axes
    (r"(^|/)embed/w$", lambda a: P(_t(a), None)),
    (r"(^|/)unembed/w$", lambda a: P(None, _t(a))),
    (r"(^|/)pos_embed/w$", lambda a: P(None, None)),
    # attention
    (r"/attn/wq$", lambda a: P(None, _t(a), None)),
    (r"/attn/wk$", lambda a: P(None, _t(a), None)),
    (r"/attn/wv$", lambda a: P(None, _t(a), None)),
    (r"/attn/wo$", lambda a: P(_t(a), None, None)),
    # dense ffn
    (r"/ffn/w_gate$", lambda a: P(None, _t(a))),
    (r"/ffn/w_up$", lambda a: P(None, _t(a))),
    (r"/ffn/w_down$", lambda a: P(_t(a), None)),
    # MoE: expert dim over tensor axes when divisible (expert parallelism),
    # param_specs falls back to ffn sharding otherwise.
    (r"/moe/w_gate$", lambda a: P(_t(a), None, None)),
    (r"/moe/w_up$", lambda a: P(_t(a), None, None)),
    (r"/moe/w_down$", lambda a: P(_t(a), None, None)),
    (r"/moe/router$", lambda a: P(None, None)),
    # mamba
    (r"/mamba/in_proj$", lambda a: P(None, _t(a))),
    (r"/mamba/out_proj$", lambda a: P(_t(a), None)),
    (r"/mamba/conv_w$", lambda a: P(_t(a), None)),
    (r"/mamba/conv_b$", lambda a: P(_t(a))),
    (r"/mamba/x_proj$", lambda a: P(_t(a), None)),
    (r"/mamba/dt_proj$", lambda a: P(None, _t(a))),
    (r"/mamba/dt_bias$", lambda a: P(_t(a))),
    (r"/mamba/A_log$", lambda a: P(_t(a), None)),
    (r"/mamba/D$", lambda a: P(_t(a))),
    # rwkv6
    (r"/rwkv/wo$", lambda a: P(_t(a), None)),
    (r"/rwkv/w[rkvg]$", lambda a: P(None, _t(a))),
    (r"/rwkv/cm_wk$", lambda a: P(None, _t(a))),
    (r"/rwkv/cm_wv$", lambda a: P(_t(a), None)),
    (r"/rwkv/cm_wr$", lambda a: P(None, _t(a))),
    (r"/rwkv/time_first$", lambda a: P(_t(a), None)),
    (r"/rwkv/(decay_)?lora_[ab]$", lambda a: P(None, None)),
    (r"/rwkv/(mix_|decay_base)", lambda a: P(None)),
    # connector (MLLM projector)
    (r"/connector/w\d$", lambda a: P(None, None)),
    # norms / biases / scalars: replicated
    (r".*", lambda a: None),
]


def _spec_for_path(path: str, assignment: AxisAssignment) -> Optional[P]:
    for pat, spec_of in _RULES:
        if re.search(pat, path):
            return spec_of(assignment)
    return None


def _module_of(path: str) -> str:
    if path.startswith("encoder/") or "/encoder/" in path:
        return "encoder"
    return "llm"


def _shape(leaf) -> tuple:
    return tuple(leaf.shape)


# MoE expert weights: sharded on E or d_ff (param_specs, expert_shards)
_EXPERT_LEAF = r"/moe/(w_gate|w_up|w_down)$"


def param_specs(params: Any, assignment: ModuleAssignment, mesh) -> Any:
    """PartitionSpec tree matching ``params`` (per-layer leaves)."""

    def rule(path: str, leaf) -> P:
        a = assignment.for_module(_module_of(path))
        shape = _shape(leaf)
        spec = _spec_for_path(path, a)
        if spec is None:
            spec = P()
        # MoE expert weights: expert-dim sharding when E divides the tensor
        # axes, else shard the FFN dim (granite 40e / mixtral 8e vs a
        # 16-wide model axis).
        m = re.search(_EXPERT_LEAF, path)
        if m and a.tensor:
            tsize = axes_size(mesh, tuple(a.tensor))
            E = shape[-3]
            if E % tsize == 0:
                spec = P(tuple(a.tensor), None, None)
            elif m.group(1) == "w_down":       # (E, ff, d)
                spec = P(None, tuple(a.tensor), None)
            else:                              # (E, d, ff)
                spec = P(None, None, tuple(a.tensor))
        # align the spec to the *trailing* dims of the leaf
        ndim = len(shape)
        pad = ndim - len(spec)
        if pad > 0:
            spec = P(*([None] * pad), *spec)
        elif pad < 0:
            spec = P(*list(spec)[-ndim:] if ndim else [])
        spec = sanitize_spec(spec, shape, mesh)
        # FSDP-shard everything except the (un)embedding tables: their
        # gradient is a contraction over *all* tokens, and a ZeRO-sharded
        # weight forces an all-gather of the (tokens, vocab) cotangent —
        # vocab-sharded-only weights all-reduce a small partial dW instead.
        is_vocab_table = re.search(r"(^|/)(embed|unembed)/w$", path) is not None
        excluded = is_vocab_table or any(re.search(p, path)
                                         for p in a.fsdp_exclude)
        if a.fsdp and a.zero and not excluded:
            spec = _with_zero(spec, shape, mesh, a.zero)
        return spec

    return tree_map_with_path_str(rule, params)


def expert_shards(params: Any, assignment: ModuleAssignment, mesh,
                  coords: Optional[dict] = None) -> Any:
    """One rank's tree for the sharded MoE paths: each expert leaf
    (``.../moe/w_up``, ``w_gate``, ``w_down``) becomes the slice that its
    ``param_specs`` spec gives this rank (the expert dim where E divides the
    tensor axes, else d_ff: the reference's shard_map ``in_specs``); every
    other leaf is returned as it is, whole (the port's layers hold
    full-width activations and replicated weights).

    ``coords`` maps each mesh axis to this rank's index on it (default: the
    ``DeviceMesh``'s coordinate of the calling rank; give it with a
    stand-in mesh).  A slice is a new leaf (a contiguous copy) that requires
    grad if its source did.  Paths match as in ``param_specs``: one layer's MoE
    params go in under a parent key, e.g. ``{"layer": {"moe": p}}``."""
    if coords is None:
        coords = {a: mesh.get_local_rank(a) for a in mesh_shape(mesh)}
    specs = dict(tree_paths(param_specs(params, assignment, mesh)))

    def cut(path: str, leaf):
        if not re.search(_EXPERT_LEAF, path):
            return leaf
        out = leaf.detach()
        for dim, entry in enumerate(specs[path]):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            idx = 0
            for a in axes:
                idx = idx * axes_size(mesh, a) + coords[a]
            size = out.shape[dim] // axes_size(mesh, axes)
            out = out.narrow(dim, idx * size, size)
        # a copy, so the whole leaf can be freed
        return out.clone(memory_format=torch.contiguous_format).requires_grad_(
            leaf.requires_grad)

    return tree_map_with_path_str(cut, params)


def _with_zero(spec: P, shape: Sequence[int], mesh, zero_axes: Tuple[str, ...]) -> P:
    """Add ZeRO axes to the largest dim that is unsharded and divisible."""
    if not zero_axes:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if e is None:
            continue
        used.update([e] if isinstance(e, str) else e)
    if used & set(zero_axes):
        return spec          # already ZeRO/FSDP-sharded on these axes
    zsize = axes_size(mesh, tuple(zero_axes))
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if entries[i] is None and shape[i] % zsize == 0 and shape[i] >= zsize:
            entries[i] = tuple(zero_axes)
            return P(*entries)
    return spec


def opt_state_specs(params: Any, pspecs: Any, assignment: ModuleAssignment,
                    mesh) -> Any:
    """Optimizer-moment specs: param specs + ZeRO sharding over `zero` axes."""
    specs = dict(tree_paths(pspecs))
    if len(specs) != len(tree_paths(params)):
        raise ValueError("pspecs do not match params leaf for leaf")

    def rule(path: str, leaf) -> P:
        a = assignment.for_module(_module_of(path))
        return _with_zero(specs[path], _shape(leaf), mesh, a.zero)

    return tree_map_with_path_str(rule, params)


# --------------------------------------------------------------------------- #
# Activation specs
# --------------------------------------------------------------------------- #
def tokens_spec(a: AxisAssignment, extra_dims: int = 1) -> P:
    """(batch, seq, ...) tokens: batch sharded over the module's batch axes."""
    return P(tuple(a.batch) if a.batch else None, *([None] * extra_dims))


def activation_spec(a: AxisAssignment, ndim: int = 3) -> P:
    """(batch, seq, d_model): d replicated; heads shard inside attention."""
    return P(tuple(a.batch) if a.batch else None, *([None] * (ndim - 1)))
