"""Map a reference parameter tree (numpy leaves) onto the port's tree.

The reference stacks each pattern position's layers along a leading
``n_blocks`` axis (``blocks/pos{j}/...``); the port keeps one dict per layer
(``layers/{i}/...``, ``i = b * period + j``).  Every leaf keeps its layout:
``wq (d, h, hd)``, ``wo (h, hd, d)``, ``unembed (d, vocab)``.

Feed it ``jax.tree.map(np.asarray, params)``: the port itself never imports
jax, so the caller turns the arrays into numpy first.  Decode caches map the
same way (``caches_from_jax``): the reference's ``pos{j}`` caches, stacked
along ``n_blocks``, become the port's list with one cache per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import trainable, tree_map
from repro_torch.common.types import MLLMConfig, ModelConfig, resolve_device


def _tensor(x, device):
    x = np.array(x, copy=True)
    if x.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: its raw bits
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(x).to(device)


def _unstack(stacked, cfg: ModelConfig, device) -> list:
    """``{pos{j}: tree of (n_blocks, ...)}`` -> one tree a layer."""
    period = cfg.block_period
    n_blocks = cfg.n_layers // period
    return [tree_map(lambda a, b=b: _tensor(np.asarray(a)[b], device),
                     stacked[f"pos{j}"])
            for b in range(n_blocks) for j in range(period)]


def _stack_from_jax(tree, cfg: ModelConfig, device):
    out = {k: tree_map(lambda x: _tensor(x, device), v)
           for k, v in tree.items() if k != "blocks"}
    out["layers"] = _unstack(tree["blocks"], cfg, device)
    return out


def params_from_jax(tree, cfg, device="cuda"):
    """``tree``: the reference's params for ``cfg`` (an ``MLLMConfig`` or a
    ``ModelConfig``) with numpy leaves.  Returns the port's params on
    ``device``, as leaves that require grad."""
    dev = resolve_device(device)
    if isinstance(cfg, MLLMConfig):
        out = {"encoder": _stack_from_jax(tree["encoder"], cfg.encoder, dev),
               "connector": tree_map(lambda x: _tensor(x, dev),
                                     tree["connector"]),
               "llm": _stack_from_jax(tree["llm"], cfg.llm, dev)}
    else:
        out = _stack_from_jax(tree, cfg, dev)
    return trainable(out)


def caches_from_jax(caches, cfg: ModelConfig, device="cuda"):
    """``caches``: the reference's decode caches for ``cfg``
    (``model.init_cache``'s layout) with numpy leaves.  Returns the port's
    per-layer list on ``device``, every leaf in its own dtype."""
    return _unstack(caches, cfg, resolve_device(device))
