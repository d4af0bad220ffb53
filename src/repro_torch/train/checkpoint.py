"""Checkpointing: tree of tensors <-> .npz + JSON metadata (no external deps).

The layout is the reference's (``train/checkpoint.py``): one ``.npz`` array
per leaf under its '/'-joined ``tree_paths`` key, and ``<path>.meta.json``
holding the caller's ``meta`` with each leaf's dtype and shape.  numpy has no
bfloat16, so a bf16 leaf is stored as its raw 16 bits (``uint16``) with
``"bfloat16"`` in the metadata, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.pytree import tree_paths

BF16 = "bfloat16"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    return (path[:-4] if path.endswith(".npz") else path) + ".meta.json"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the metadata)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = [(p, *_to_numpy(leaf)) for p, leaf in tree_paths(tree)]
    np.savez(_npz_path(path), **{p: a for p, a, _ in flat})
    with open(_meta_path(path), "w") as f:
        json.dump({"meta": meta or {},
                   "dtypes": {p: dt for p, _, dt in flat},
                   "shapes": {p: list(a.shape) for p, a, _ in flat}},
                  f, indent=1)


def _leaf(arr: np.ndarray, dtype_name: str, ref):
    """The stored array as a leaf like ``ref``: a tensor on ``ref``'s device
    in ``ref``'s dtype (requiring grad where ``ref`` does), else a Python
    scalar or a numpy array."""
    if not isinstance(ref, torch.Tensor):
        if np.ndim(ref) == 0 and not isinstance(ref, np.ndarray):
            return type(ref)(arr.item())
        return np.asarray(arr, dtype=np.asarray(ref).dtype)
    if dtype_name == BF16:
        t = torch.from_numpy(arr.copy().view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    out = t.to(device=ref.device, dtype=ref.dtype)
    return out.requires_grad_(True) if ref.requires_grad else out


def _rebuild(like: Any, leaves: dict, prefix: str = "") -> Any:
    """``like``'s structure with each leaf taken from ``leaves`` by path."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, key(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, key(i)) for i, v in enumerate(like))
    return leaves[prefix]


def restore(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes validated; each leaf
    takes ``like``'s dtype and device)."""
    npz = np.load(_npz_path(path))
    dtypes = load_meta(path).get("dtypes", {})
    leaves = {}
    for p, ref in tree_paths(like):
        if p not in npz:
            raise KeyError(f"checkpoint missing leaf {p}")
        arr = npz[p]
        ref_shape = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
        if tuple(arr.shape) != tuple(ref_shape):
            raise ValueError(f"{p}: shape {arr.shape} != expected {ref_shape}")
        leaves[p] = _leaf(arr, dtypes.get(p, str(arr.dtype)), ref)
    return _rebuild(like, leaves)


def load_meta(path: str) -> dict:
    with open(_meta_path(path)) as f:
        return json.load(f)
