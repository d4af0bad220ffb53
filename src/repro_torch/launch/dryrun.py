"""Multi-pod dry run: the port's counterpart of ``repro/launch/dryrun.py``.

Builds the production train, prefill or decode step of an architecture for
one input shape on the 16x16 mesh (or 2x16x16, two pods) and runs it once on
fake tensors, as rank 0 of a fake process group of 256 (512) ranks, to show
before any launch whether the plan fits on each rank.  It records the
rank's memory, FLOPs, HBM bytes and collective bytes
(``repro_torch.launch.hlo_stats``) as JSON.  Its numbers are predictions
from fake tensors, not measurements: nothing runs on a card, and no card is
needed beyond what a ``cuda`` mesh asks of the process (``--device cuda``,
the default; ``--device cpu`` builds the same step on CPU fake tensors).

Where the reference jits the step with ``in_shardings`` over 512 placeholder
devices, the port

  * starts a fake process group (``FakeStore``, backend ``"fake"``) unless
    one is up, and builds the production mesh on it;
  * creates parameters, AdamW moments and the batch under ``FakeTensorMode``
    (no memory) and places them as DTensors by ``param_specs`` /
    ``opt_state_specs`` / the batch specs;
  * runs the step under ``implicit_replication`` (a plain tensor the model
    makes, e.g. positions, is replicated), with the reference's sharding
    hooks in ``FwdCtx`` as DTensor redistributes; the sharded layer paths
    (expert-parallel and TP-expert MoE, the channel-sharded Mamba scan, the
    vocab-parallel CE, the communicator) and the kernels K1–K7 run on each
    rank's local tensors inside ``local_map`` at the reference's specs;
  * returns each gradient to its parameter's placements (``train.step``'s
    fp32 buffers take them) before AdamW;
  * runs the step once under a ``MemTracker`` and the ``hlo_stats``
    recorder.

The record keeps the reference's keys, with ``fits_80gb`` (against
``H100.mem_bytes``) for ``fits_16gb`` and ``trace_s`` (host seconds of the
fake run) for ``lower_s``/``compile_s``.  ``code_bytes`` and ``xla_cost``
are dropped: an eager step compiles no program, and its cost is the
recorder's.  ``memory``: ``argument_bytes`` is the rank's share of the
step's inputs, ``peak_per_chip`` the tracker's peak of live bytes,
``output_bytes`` the rank's share of what the step returns and
``alias_bytes`` the part of it written in place over its inputs (parameters
and moments, decode caches: the reference's donated buffers), so that
``peak = argument + output + temp - alias`` as in the reference.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \\
        --shape train_4k [--multi-pod] [--device cpu] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common.pytree import tree_leaves, tree_map, tree_map_with_path_str
from repro_torch.common.types import INPUT_SHAPES, MLLMConfig, ModelConfig, ShapeSpec
from repro_torch.configs import ASSIGNED, ArchSpec, get_config
from repro_torch.core.communicator import make_communicator
from repro_torch.core.profiling.analytic import H100
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import (axes_size, batch_axes, make_production_mesh,
                                    mesh_shape, model_axes)
from repro_torch.models import mllm as mllm_lib
from repro_torch.models import model as model_lib
from repro_torch.models.model import FwdCtx
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.sharding.partition import (AxisAssignment, ModuleAssignment, P,
                                            opt_state_specs, param_specs,
                                            sanitize_spec, to_placements)
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.step import make_train_step

# per-arch microbatch counts for train_4k (memory-driven)
N_MB = {"default": 8, "jamba-v0.1-52b": 16, "mixtral-8x7b": 16,
        "starcoder2-15b": 16}
# per-arch MoE dispatch chunk (tokens)
MOE_CHUNK = {"default": 8192}

MEM_CAP_BYTES = H100.mem_bytes        # 80 GB of the H100


# --------------------------------------------------------------------------- #
# Sharding plans
# --------------------------------------------------------------------------- #
def make_assignment(mesh, spec: ArchSpec, *, heterogeneous: bool = True,
                    fsdp: bool = True) -> ModuleAssignment:
    """DFLOP plan on the fixed mesh: LLM uses the model axis for tensor
    sharding; the encoder (small, batch-rich) runs tp=1 with the model axis
    joined to its batch sharding — the SPMD realization of independent
    per-module 3D parallelism."""
    b, m = batch_axes(mesh), model_axes(mesh)
    zero = b          # ZeRO over all batch axes (pod + data on multi-pod)
    llm = AxisAssignment(batch=b, tensor=m, zero=zero, fsdp=fsdp)
    enc = None
    if spec.is_mllm:
        if heterogeneous:
            enc = AxisAssignment(batch=b + m, tensor=(), zero=zero, fsdp=fsdp)
        else:
            enc = AxisAssignment(batch=b, tensor=m, zero=zero, fsdp=fsdp)
    return ModuleAssignment(llm=llm, encoder=enc)


def _redistribute(x, mesh, spec: P):
    """``x`` (a DTensor) with the placements of ``spec`` (sanitised for its
    shape): the counterpart of ``with_sharding_constraint``."""
    s = sanitize_spec(spec, tuple(x.shape), mesh)
    return x.redistribute(mesh, to_placements(s, mesh))


def moe_constrain_fn(mesh, cfg: ModelConfig, assignment: AxisAssignment):
    """Sharding constraint for the (E, C, d) MoE dispatch buffers: expert
    parallelism when E divides the tensor axes, else shard capacity over the
    batch axes."""
    if cfg.n_experts == 0:
        return None
    t = assignment.tensor
    if t and cfg.n_experts % axes_size(mesh, tuple(t)) == 0:
        spec = P(tuple(t), tuple(assignment.batch) or None, None)
    else:
        spec = P(None, tuple(assignment.batch) or None, None)
    return lambda x: _redistribute(x, mesh, spec)


def block_gather_constrain(mesh, params, assignment: ModuleAssignment,
                           module: str = "llm"):
    """ZeRO-3 weight gather for one layer: redistribute its leaves to their
    non-FSDP layout (tensor-sharded, replicated over the zero axes).
    Applied inside the layer's checkpoint, the gather runs again in the
    backward, and its backward reduce-scatters dW.  ``params``: the module's
    param tree (``layers/{i}/...``)."""
    a = assignment.for_module(module)
    if not (a.fsdp and a.zero):
        return None
    a2 = dataclasses.replace(a, fsdp=False)
    specs = param_specs({"layers": params["layers"]}, ModuleAssignment(llm=a2),
                        mesh)["layers"]

    def constrain(lp, i):
        return tree_map(lambda x, sp: _redistribute(x, mesh, sp), lp, specs[i])

    return constrain


def hidden_constrain_fn(mesh, assignment: AxisAssignment):
    """Anchor (B, S, d) activations: batch over the module's batch axes."""
    b = tuple(assignment.batch)
    return lambda x: _redistribute(x, mesh, P(b or None, None, None))


def logits_constrain_fn(mesh, cfg: ModelConfig, assignment: AxisAssignment):
    """Shard the (B, S, vocab) logits over the tensor axes on the vocab dim."""
    b, t = tuple(assignment.batch), tuple(assignment.tensor)
    return lambda x: _redistribute(x, mesh, P(b or None, None, t or None))


def cache_specs(cfg: ModelConfig, caches, mesh, assignment: AxisAssignment,
                batch: int):
    """KV/state cache specs (the reference's, without its leading n_blocks
    entry: the port keeps one cache a layer).  The sequence dim of KV
    caches shards over the model axis (flash-decoding style); for batch=1
    long-context the data axes join in."""
    b = tuple(assignment.batch)
    m = tuple(assignment.tensor)
    seq_axes = m if batch > 1 else tuple(assignment.batch) + m

    def rule(path: str, leaf):
        if path.endswith("/k") or path.endswith("/v"):
            spec = P(b or None, seq_axes or None, None, None)
        elif path.endswith("/kpos"):
            spec = P(b or None, seq_axes or None)
        elif path.endswith("/conv"):
            spec = P(b or None, None, m or None)
        elif path.endswith("/ssm"):
            spec = P(b or None, m or None, None)
        elif path.endswith("/wkv"):
            spec = P(b or None, m or None, None, None)
        elif path.endswith("_prev"):
            spec = P(b or None, m or None)
        else:
            spec = P()
        return sanitize_spec(spec, tuple(leaf.shape), mesh)

    return tree_map_with_path_str(rule, caches)


# --------------------------------------------------------------------------- #
# Fake inputs
# --------------------------------------------------------------------------- #
def _place(x, mesh, spec: P, requires_grad: bool = False):
    """Global fake tensor ``x`` as a DTensor placed by ``spec``."""
    from torch.distributed.tensor import distribute_tensor
    s = sanitize_spec(spec, tuple(x.shape), mesh)
    out = distribute_tensor(x.detach(), mesh, to_placements(s, mesh))
    return out.requires_grad_(requires_grad)


def _placed_tree(tree, specs, mesh, requires_grad: bool = False):
    return tree_map(lambda x, s: _place(x, mesh, s, requires_grad), tree, specs)


def _sds(shape, dtype, mesh, spec, device):
    """A zero fake DTensor of ``shape`` placed by ``spec`` (the reference's
    ``ShapeDtypeStruct`` with a sharding)."""
    return _place(torch.zeros(shape, dtype=dtype, device=device), mesh, spec)


def media_split(spec: ArchSpec, seq_len: int) -> tuple[int, int, int]:
    """(media items, encoder tokens, text tokens) for an MLLM sample whose
    LLM sequence is `seq_len` (≈half media, half text)."""
    mcfg: MLLMConfig = spec.desc
    tpm = spec.tokens_per_media_item or mcfg.tokens_per_item_out or 196
    n_items = max(1, (seq_len // 2) // tpm)
    enc_tokens = n_items * mcfg.stub.n_tokens
    text = seq_len - n_items * tpm
    return n_items, enc_tokens, text


def input_specs(spec: ArchSpec, shape: ShapeSpec, mesh, n_mb: int,
                device="cpu"):
    """Fake DTensors for the train step's data inputs (leading microbatch
    axis), placed by the reference's batch specs."""
    assignment = make_assignment(mesh, spec)
    b_axes = tuple(assignment.llm.batch)
    desc = spec.desc
    mb = shape.global_batch // n_mb
    S = shape.seq_len
    bspec3 = P(None, b_axes or None, None)
    bspec4 = P(None, b_axes or None, None, None)
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dtype, sp):
        return _sds(shp, dtype, mesh, sp, device)

    if isinstance(desc, MLLMConfig):
        n_items, enc_tok, text = media_split(spec, S)
        e_spec = P(None, tuple(assignment.for_module("encoder").batch) or None,
                   None, None)
        return {
            "media_embeds": sds((n_mb, mb, enc_tok, desc.stub.embed_dim), bf16, e_spec),
            "media_mask": sds((n_mb, mb, enc_tok), i32, bspec3),
            "text_tokens": sds((n_mb, mb, text), i32, bspec3),
            "text_mask": sds((n_mb, mb, text), i32, bspec3),
            "labels": sds((n_mb, mb, text), i32, bspec3),
        }
    if desc.input_embed_dim > 0:
        return {
            "frame_embeds": sds((n_mb, mb, S, desc.input_embed_dim), bf16, bspec4),
            "labels": sds((n_mb, mb, S), i32, bspec3),
        }
    return {
        "tokens": sds((n_mb, mb, S), i32, bspec3),
        "labels": sds((n_mb, mb, S), i32, bspec3),
        "segment_ids": sds((n_mb, mb, S), i32, bspec3),
        "positions": sds((n_mb, mb, S), i32, bspec3),
    }


# --------------------------------------------------------------------------- #
# Step builders: (fn, args, extra, what the step returns in place, note_loops)
# --------------------------------------------------------------------------- #
def _dryrun_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")


def _dryrun_desc(spec: ArchSpec):
    d = spec.desc
    if isinstance(d, MLLMConfig):
        return dataclasses.replace(d, encoder=_dryrun_cfg(d.encoder),
                                   llm=_dryrun_cfg(d.llm))
    return _dryrun_cfg(d)


def _init_params(desc, device):
    if isinstance(desc, MLLMConfig):
        return mllm_lib.init(desc, device=device)
    return model_lib.init(desc, device=device)


@dataclasses.dataclass
class Built:
    """A step ready to run once: ``fn(*args)``; ``in_place`` the part of
    ``args`` the step writes in place (the reference's donated buffers);
    ``loops`` the Python loops it runs, for ``while_trips``."""
    fn: object
    args: tuple
    extra: dict
    in_place: tuple = ()
    loops: dict = dataclasses.field(default_factory=dict)


def build_train(spec: ArchSpec, shape: ShapeSpec, mesh, device="cpu") -> Built:
    desc = _dryrun_desc(spec)
    assignment = make_assignment(mesh, spec)
    n_mb = N_MB.get(spec.arch_id, N_MB["default"])
    llm_cfg = desc.llm if isinstance(desc, MLLMConfig) else desc

    params = _init_params(desc, device)
    pspecs = param_specs(params, assignment, mesh)
    moment_specs = opt_state_specs(params, pspecs, assignment, mesh)
    opt = adamw_init(params)
    params = _placed_tree(params, pspecs, mesh, requires_grad=True)
    opt = {"m": _placed_tree(opt["m"], moment_specs, mesh),
           "v": _placed_tree(opt["v"], moment_specs, mesh), "step": opt["step"]}

    batch = input_specs(spec, shape, mesh, n_mb, device)
    communicator = None
    if isinstance(desc, MLLMConfig):
        communicator = make_communicator(mesh, assignment.for_module("encoder"),
                                         assignment.llm)
    shard_ctx = (mesh, tuple(assignment.llm.batch), tuple(assignment.llm.tensor))
    # the reference's "chunked" attention and scans: the port's kernels (K1-K7
    # on each rank's shards; see PERF.md for why the scans take them too)
    ctx = FwdCtx(mode="train", attn_impl="kernel", attn_block=1024,
                 ssm_impl="kernel", moe_impl="ep", capacity_factor=1.25,
                 moe_chunk_tokens=MOE_CHUNK.get(spec.arch_id, MOE_CHUNK["default"]),
                 moe_constrain=moe_constrain_fn(mesh, llm_cfg, assignment.llm),
                 hidden_constrain=hidden_constrain_fn(mesh, assignment.llm),
                 logits_constrain=logits_constrain_fn(mesh, llm_cfg, assignment.llm),
                 shard_ctx=shard_ctx)
    from repro_torch.sharding.vocab_ce import make_vocab_parallel_ce
    vocab_ce = make_vocab_parallel_ce(
        mesh, tuple(assignment.llm.batch), tuple(assignment.llm.tensor),
        llm_cfg.vocab_size, tied=llm_cfg.tie_embeddings)
    # ZeRO-3 per-layer weight gathers (reduce-scattered dW in the backward)
    enc_ctx = None
    if isinstance(desc, MLLMConfig):
        ctx.block_constrain = block_gather_constrain(mesh, params["llm"], assignment)
        enc_ctx = dataclasses.replace(
            ctx, moe_constrain=None, logits_constrain=None,
            block_constrain=block_gather_constrain(mesh, params["encoder"],
                                                   assignment, "encoder"))
    else:
        ctx.block_constrain = block_gather_constrain(mesh, params, assignment)
    step = make_train_step(desc, AdamWConfig(), ctx=ctx, communicator=communicator,
                           vocab_ce=vocab_ce, enc_ctx=enc_ctx)

    def wrapped(params, opt_state, batch):
        return step(params, opt_state, batch, 1e-4)

    loops = {"microbatches": n_mb, "llm_layers": llm_cfg.n_layers}
    if isinstance(desc, MLLMConfig):
        loops["encoder_layers"] = desc.encoder.n_layers
    return Built(wrapped, (params, opt, batch),
                 {"n_mb": n_mb, "assignment": "dflop-heterogeneous"},
                 in_place=(params, opt), loops=loops)


def build_prefill(spec: ArchSpec, shape: ShapeSpec, mesh, device="cpu") -> Built:
    desc = _dryrun_desc(spec)
    # FSDP-sharded weights, gathered a layer at a time (the reference leaves
    # the gathers to XLA; DTensor, left to itself, moves the activations)
    assignment = make_assignment(mesh, spec, fsdp=True)
    llm_cfg = desc.llm if isinstance(desc, MLLMConfig) else desc
    b_axes = tuple(assignment.llm.batch)
    B, S = shape.global_batch, shape.seq_len
    params = _init_params(desc, device)
    # shard_ctx: the MoE layers take the port's per-rank EP / TP-expert
    # paths, where the reference lets GSPMD place the capacity path's
    # buffers by moe_constrain (the same expert-over-model layout)
    shard_ctx = (mesh, tuple(assignment.llm.batch), tuple(assignment.llm.tensor))
    ctx = FwdCtx(mode="prefill", remat=False, attn_impl="kernel",
                 attn_block=1024, ssm_impl="kernel", moe_impl="ep",
                 capacity_factor=1.25, moe_chunk_tokens=8192, shard_ctx=shard_ctx,
                 moe_constrain=moe_constrain_fn(mesh, llm_cfg, assignment.llm),
                 hidden_constrain=hidden_constrain_fn(mesh, assignment.llm),
                 logits_constrain=logits_constrain_fn(mesh, llm_cfg, assignment.llm))

    def sds(shp, dtype, sp):
        return _sds(shp, dtype, mesh, sp, device)

    if isinstance(desc, MLLMConfig):
        n_items, enc_tok, text = media_split(spec, S)
        e_spec = P(tuple(assignment.for_module("encoder").batch) or None, None, None)
        batch = {
            "media_embeds": sds((B, enc_tok, desc.stub.embed_dim), torch.bfloat16, e_spec),
            "media_mask": sds((B, enc_tok), torch.int32, P(b_axes or None, None)),
            "text_tokens": sds((B, text), torch.int32, P(b_axes or None, None)),
            "text_mask": sds((B, text), torch.int32, P(b_axes or None, None)),
        }
        communicator = make_communicator(mesh, assignment.for_module("encoder"),
                                         assignment.llm)
        ctx = dataclasses.replace(ctx, return_hidden=True, block_constrain=(
            block_gather_constrain(mesh, params["llm"], assignment)))
        enc_ctx = dataclasses.replace(
            ctx, moe_constrain=None, logits_constrain=None,
            block_constrain=block_gather_constrain(mesh, params["encoder"],
                                                   assignment, "encoder"))
        from repro_torch.models.layers import embed as embed_lib

        @torch.no_grad()
        def prefill(params, batch):
            # serving prefill: last-position logits only (next token)
            h, _ = mllm_lib.forward_train(
                params, desc, {**batch, "labels": batch["text_tokens"]},
                ctx=ctx, communicator=communicator, enc_ctx=enc_ctx)
            h_last = h[:, -1:]
            llm_p = params["llm"]
            if desc.llm.tie_embeddings or "unembed" not in llm_p:
                return embed_lib.decode(llm_p["embed"], h_last)
            return embed_lib.unembed(llm_p["unembed"], h_last)
    else:
        ctx.block_constrain = block_gather_constrain(mesh, params, assignment)
        prefill = make_prefill_step(desc, ctx)
        if desc.input_embed_dim > 0:
            batch = {"frame_embeds": sds((B, S, desc.input_embed_dim),
                                         torch.bfloat16, P(b_axes or None, None, None))}
        else:
            batch = {"tokens": sds((B, S), torch.int32, P(b_axes or None, None))}

    pspecs = param_specs(params, assignment, mesh)
    params = _placed_tree(params, pspecs, mesh)
    loops = {"llm_layers": llm_cfg.n_layers}
    if isinstance(desc, MLLMConfig):
        loops["encoder_layers"] = desc.encoder.n_layers
    return Built(prefill, (params, batch), {"assignment": "dflop-heterogeneous"},
                 loops=loops)


def build_decode(spec: ArchSpec, shape: ShapeSpec, mesh, device="cpu") -> Built:
    desc = _dryrun_desc(spec)
    llm_cfg = desc.llm if isinstance(desc, MLLMConfig) else desc
    # FSDP weights + per-layer ZeRO-3 gathers inside the decode layer loop:
    # weights stay data-sharded at rest and one layer's gathered copy is live
    assignment = make_assignment(mesh, spec, fsdp=True)
    a = assignment.llm
    B, S = shape.global_batch, shape.seq_len
    if isinstance(desc, MLLMConfig):
        full = mllm_lib.init(desc, device=device)
        pspecs = param_specs(full, assignment, mesh)["llm"]
        params = full["llm"]
    else:
        params = model_lib.init(llm_cfg, device=device)
        pspecs = param_specs(params, assignment, mesh)
    caches = model_lib.init_cache(llm_cfg, B, S, kv_dtype=torch.bfloat16,
                                  device=device)
    cspecs = cache_specs(llm_cfg, caches, mesh, a, B)
    b_axes = tuple(a.batch)
    tok = _sds((B,), torch.int32, mesh, P(b_axes if B > 1 else None), device)
    decode_ctx = FwdCtx(mode="decode", remat=False, moe_impl="ep",
                        shard_ctx=(mesh, b_axes, tuple(a.tensor)),
                        block_constrain=block_gather_constrain(mesh, params, assignment))
    decode = make_decode_step(llm_cfg, ctx=decode_ctx)
    params = _placed_tree(params, pspecs, mesh)
    caches = _placed_tree(caches, cspecs, mesh)
    pos = torch.full((), S - 1, dtype=torch.int32, device=device)

    @torch.no_grad()
    def step(params, caches, tok, pos):
        return decode(params, caches, tok, pos)

    return Built(step, (params, caches, tok, pos),
                 {"cache_len": S, "assignment": "dflop-heterogeneous"},
                 in_place=(caches,), loops={"llm_layers": llm_cfg.n_layers})


BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


# --------------------------------------------------------------------------- #
# Runner
# --------------------------------------------------------------------------- #
def start_fake_group(world: int) -> bool:
    """A fake process group of ``world`` ranks (this process rank 0) unless
    one is up; True if this call started it."""
    if dist.is_initialized():
        return False
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return True


def _mem_tracker():
    """A ``torch.distributed._tools.mem_tracker.MemTracker`` that skips
    DTensor's shape propagation (``hlo_stats.muted``)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor

    class Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if hlo_stats.muted() and not any(issubclass(t, DTensor) for t in types):
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Tracker()


def _bytes(tree) -> int:
    return sum(hlo_stats.tensor_bytes(t) for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def trace_step(built: Built):
    """Run ``built`` once under the memory tracker and the recorder.
    Returns (memory dict, HloStats, host seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    mt = _mem_tracker()
    mt.track_external(*[t for t in tree_leaves(built.args)
                        if isinstance(t, torch.Tensor)])
    rec = hlo_stats.Recorder()
    for name, trips in built.loops.items():
        rec.note_loop(name, trips)
    arg_bytes = _bytes(built.args)
    alias = _bytes(built.in_place)
    t0 = time.monotonic()
    with implicit_replication(), hlo_stats.muted_propagation(), mt, rec:
        out = built.fn(*built.args)
    trace_s = time.monotonic() - t0
    peak = sum(snap["Total"] for snap in mt.get_tracker_snapshot("peak").values())
    # what the step returns: in place over its inputs (aliased), plus the rest
    in_place_ids = {id(t) for t in tree_leaves(built.in_place)}
    out_bytes = alias + sum(hlo_stats.tensor_bytes(t) for t in tree_leaves(out)
                            if isinstance(t, torch.Tensor) and id(t) not in in_place_ids)
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": peak - arg_bytes - out_bytes + alias,
              "alias_bytes": alias, "peak_per_chip": peak}
    return memory, rec.stats, trace_s


def _fake_mode():
    """The mode the dry run's tensors are made and run in (the mesh's own
    rank tensors are real)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            out_dir: Optional[str] = None, verbose: bool = True,
            device: str = "cuda", spec: Optional[ArchSpec] = None,
            shape: Optional[ShapeSpec] = None, mesh=None) -> dict:
    """Dry-run one combination and return (and with ``out_dir`` write) its
    record.  ``spec``, ``shape`` and ``mesh`` override the registry's arch,
    the named shape and the production mesh (tests use reduced configs on
    a small mesh)."""
    spec = spec or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    support = spec.shape_support(shape)
    mesh_name = ("2x16x16" if multi_pod else "16x16") if mesh is None else \
        "x".join(str(s) for s in mesh_shape(mesh).values())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": support, "ok": False}
    if support.startswith("skip"):
        rec.update(ok=True, skipped=True, reason=support)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: {support}")
        return _dump(rec, out_dir)
    try:
        if mesh is None:
            start_fake_group(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        with _fake_mode():
            built = BUILDERS[support](spec, shape, mesh, device)
            memory, stats, trace_s = trace_step(built)
        n_chips = 1
        for s in mesh_shape(mesh).values():
            n_chips *= s
        llm_cfg = spec.llm_cfg
        mode = support
        tokens = shape.global_batch * (1 if mode == "decode" else shape.seq_len)
        n_active = llm_cfg.active_param_count()
        if spec.is_mllm and mode != "decode":
            n_active += spec.desc.encoder.param_count()
        # 6·N·D for training (fwd+bwd), 2·N·D for inference forward
        model_fl = (6.0 if mode == "train" else 2.0) * n_active * tokens
        rec.update(
            ok=True, skipped=False, n_chips=n_chips, trace_s=round(trace_s, 2),
            memory=memory, hlo=stats.as_dict(), model_flops=model_fl,
            tokens=tokens, params=spec.desc.param_count(),
            active_params=(llm_cfg.active_param_count()
                           + (spec.desc.encoder.param_count() if spec.is_mllm else 0)),
            **built.extra)
        rec["fits_80gb"] = bool(memory["peak_per_chip"] <= MEM_CAP_BYTES)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"trace={trace_s:.1f}s peak={memory['peak_per_chip'] / 1e9:.2f}GB "
                  f"flops/chip={stats.flops:.3e} "
                  f"coll={stats.total_collective_bytes:.3e}B")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL {e}")
    return _dump(rec, out_dir)


def _dump(rec: dict, out_dir: Optional[str]) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the fake tensors and the mesh")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    archs = ASSIGNED if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    combos = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    start_fake_group(512 if any(meshes) else 256)
    failures = 0
    for a, s, mp in combos:
        rec = run_one(a, s, mp, args.out, device=args.device)
        failures += 0 if rec["ok"] else 1
    print(f"[dryrun] done: {len(combos)} combos, {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
