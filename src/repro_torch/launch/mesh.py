"""Device meshes on ``torch.distributed`` (the reference's TPU meshes).

A mesh is a ``DeviceMesh`` over the ranks of an initialised process group:
one process a card (NCCL) by default, or one a CPU core under gloo, as the
tests run it.  Nothing here starts a process group; the caller does, with
its own store, world size and rank, and every rank of that group calls the
same mesh functions (a ``DeviceMesh`` creates a sub-group per axis slice, a
collective call).  Asking for a CUDA mesh without a card raises: nothing
falls back to gloo or the CPU.

The sharding rules read sizes only through ``mesh_shape``, which takes a
``DeviceMesh`` or any object with a ``.shape`` mapping of axis name to size
(a stand-in for a production mesh that no process group backs).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.common.types import resolve_device


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's axis order."""
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        # .shape, not .mesh.shape: the rank tensor is rebuilt on every read
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axes_size(mesh, axes) -> int:
    """Product of the sizes of ``axes`` (None, an axis name or a tuple of
    names) on ``mesh``."""
    if axes is None:
        return 1
    sizes = mesh_shape(mesh)
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= sizes[a]
    return n


def make_mesh(shape: Sequence[int], axes: Sequence[str], ranks=None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group: every rank of it (``init_device_mesh``), or the listed
    ``ranks`` in row-major order (the reference's ``devices=``: a re-planned
    theta* rarely uses every card)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if ranks is None:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    ids = torch.as_tensor(list(ranks), dtype=torch.int64)
    if ids.numel() != int(torch.tensor(shape).prod()):
        raise ValueError(f"{ids.numel()} ranks do not fill a mesh of {shape}")
    return DeviceMesh(device_type, ids.reshape(shape), mesh_dim_names=axes)


def host_groups(devices, per_host: int):
    """Partition a flat device list into contiguous emulated "hosts" of
    ``per_host`` devices each.  Raises on a ragged split — every host must
    field the same device count or per-host data shards stop being
    comparable."""
    devices = list(devices)
    if per_host < 1 or len(devices) % per_host:
        raise ValueError(
            f"{len(devices)} devices do not split into hosts of {per_host}")
    return [devices[i:i + per_host]
            for i in range(0, len(devices), per_host)]


def serve_device_pools(n_prefill: int, n_decode: int, devices=None):
    """Assign the serving engine's worker pools to devices (prefill/decode
    disaggregation).  With enough devices the pools are disjoint and the KV
    handoff is a device-to-device copy; fewer devices wrap round-robin, down
    to one card that holds both pools.  ``devices`` defaults to every CUDA
    card (raising without one)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_concrete(d) for d in devices]
    if n_prefill < 1 or n_decode < 1:
        raise ValueError("both pools need at least one worker")
    total = n_prefill + n_decode
    if len(devs) >= total:
        return devs[:n_prefill], devs[n_prefill:total]
    pre = [devs[i % len(devs)] for i in range(n_prefill)]
    dec = [devs[(n_prefill + i) % len(devs)] for i in range(n_decode)]
    return pre, dec


def _concrete(device) -> torch.device:
    """``device`` with its index (``cuda`` → ``cuda:<current>``), so that one
    card has one name."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 (256 ranks) or 2x16x16 two-pod (512 ranks): every rank of the
    process group, or its first 256 (512) where it has more."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    ranks = range(n) if dist.is_initialized() and dist.get_world_size() > n else None
    return make_mesh(shape, axes, ranks=ranks, device_type=device_type)


def make_host_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """Small mesh over every rank of the process group (tests, examples)."""
    return make_mesh(shape, axes, device_type=device_type)


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch by default: pod (if present) + data."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axes(mesh) -> tuple:
    return ("model",) if "model" in mesh_shape(mesh) else ()
