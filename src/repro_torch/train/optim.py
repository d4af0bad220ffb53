"""AdamW with decoupled weight decay + cosine schedule.

``adamw_update`` updates the parameters and moments in place (under
``no_grad``) and returns them: the reference returns new trees, but at full
size a second copy of params, m and v would not fit beside the first.

Weight decay takes the leaves the reference decays, those of two or more
dims in its layout.  The reference stacks each layer's leaves along a
leading axis, so a layer's one-dim leaves (norm scales) decay too; the
port keeps one dict per layer (``layers/{i}/...``) and counts that axis."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.common.pytree import global_norm, tree_leaves, tree_paths, tree_zeros_like


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params):
    return {"m": tree_zeros_like(params, torch.float32),
            "v": tree_zeros_like(params, torch.float32),
            "step": 0}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr=None):
    lr = cfg.lr if lr is None else float(lr)
    step = state["step"] + 1
    flat_g = tree_leaves(grads)
    if cfg.grad_clip:
        gnorm = global_norm(flat_g)
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
        for g in flat_g:
            g.mul_(scale)
    # bias corrections in fp32, as the reference computes b ** step
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32) ** step
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32) ** step
    for (path, p), g, m, v in zip(tree_paths(params), flat_g, tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
        g32 = g.float()
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        delta = (m / bc1.item()) / (torch.sqrt(v / bc2.item()) + cfg.eps)
        if p.ndim + ("layers" in path.split("/")) >= 2 and cfg.weight_decay:
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}


def cosine_lr(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def schedule(step):
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 *
                          (1 + math.cos(math.pi * prog)))

    return schedule
