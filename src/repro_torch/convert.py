"""Map a reference parameter tree (numpy leaves) onto the port's tree.

The reference stacks each pattern position's layers along a leading
``n_blocks`` axis (``blocks/pos{j}/...``); the port keeps one dict per layer
(``layers/{i}/...``, ``i = b * period + j``).  Every leaf keeps its layout:
``wq (d, h, hd)``, ``wo (h, hd, d)``, ``unembed (d, vocab)``.

Feed it ``jax.tree.map(np.asarray, params)``: the port itself never imports
jax, so the caller turns the arrays into numpy first.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import trainable, tree_map
from repro_torch.common.types import MLLMConfig, ModelConfig, resolve_device


def _stack_from_jax(tree, cfg: ModelConfig, device):
    def t(x):
        return torch.as_tensor(np.array(x, copy=True)).to(device)

    out = {k: tree_map(t, v) for k, v in tree.items() if k != "blocks"}
    period = cfg.block_period
    n_blocks = cfg.n_layers // period
    out["layers"] = [
        tree_map(lambda a, b=b: t(np.asarray(a)[b]), tree["blocks"][f"pos{j}"])
        for b in range(n_blocks) for j in range(period)]
    return out


def params_from_jax(tree, cfg, device="cuda"):
    """``tree``: the reference's params for ``cfg`` (an ``MLLMConfig`` or a
    ``ModelConfig``) with numpy leaves.  Returns the port's params on
    ``device``, as leaves that require grad."""
    dev = resolve_device(device)
    if isinstance(cfg, MLLMConfig):
        out = {"encoder": _stack_from_jax(tree["encoder"], cfg.encoder, dev),
               "connector": tree_map(
                   lambda x: torch.as_tensor(np.array(x, copy=True)).to(dev),
                   tree["connector"]),
               "llm": _stack_from_jax(tree["llm"], cfg.llm, dev)}
    else:
        out = _stack_from_jax(tree, cfg, dev)
    return trainable(out)
