"""The DFLOP training loop of ``drivers/dflop_train.py`` for a hybrid
Mamba/attention decoder with a tied head (Jamba): the same set-up, window,
traced steps, check and faults, run on a private copy of that module whose
Dims, weights and port configuration are the hybrid's
(``portbench/hybrid.py``), against ``references/jamba.py``.

One more fault: ``no_reset`` trains with the Mamba layers running across
packed-segment boundaries (``ssm_segment_reset`` off), so each sample of a
row inherits the previous sample's conv window and state.  Against the
reference, the loss over each later segment's first tokens does not tell it
apart at the seed's weights (the bf16 step moves that loss as much as the
leak does), so the check adds ``seg_leak``: with the seed's weights, before
the first step, the program's final hidden states of the first check step's
rows, and again with the tokens of each row's first segment replaced; the
largest relative change, ||h' - h|| / ||h||, over the first ``HEAD_TOKENS``
tokens of every later segment (``head_mask``; the padding, id 0, left out).
The reference runs each segment alone, so its own reading is 0; a program
whose segments are apart reads 0 too, since nothing of an earlier segment
enters a later one's arithmetic but through a product with 0.

``seg_leak`` is a forward: it sees K4 and the conv, not K5.  Its backward
twin ``seg_leak_grad`` runs the program's autograd path (the kernels, K5
with its restarts, each layer recomputed as in training) from the seed's
weights over the same rows: the gradient, with respect to the embedded
inputs of each row's first segment, of the summed loss over the labels of
the later segments, over that of the whole row's summed loss; the largest
such ratio.  0 by construction in the reference and in a program whose
segments are apart.  Fault ``bwd_leak`` plants a leak in the backward
alone: K5 (or its plain version) runs without the restart words, K4 with
them.

``grad1_dense``: ``grad1`` over the leaves outside the Mamba mixers (the
embedding and head, the norms, the attention and FFN projections).  The
mixers' leaves read up to tens of percent on sound seeds (the inner norms'
scales; ``x_proj`` through them), which hides ``half_batch`` in ``grad1``;
the dense leaves read as a dense decoder's do.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import hybrid
from portbench.core import load_module

HEAD_TOKENS = 128

_base = load_module("drivers", "dflop_train")
_base.dims = hybrid.dims
_base.weights = hybrid
_base._port_config = hybrid.port_config

CHECK_STEPS, SETUP_STEPS, TRACE_STEPS = _base.CHECK_STEPS, _base.SETUP_STEPS, _base.TRACE_STEPS
data_check, window, traced = _base.data_check, _base.window, _base.traced


def head_mask(seg) -> np.ndarray:
    """(..., S) bool over the segment ids of packed rows: the first
    ``HEAD_TOKENS`` tokens of each segment after a row's first (the
    padding, id 0, left out)."""
    seg = np.asarray(seg)
    out = np.zeros(seg.shape, bool)
    for idx in np.ndindex(*seg.shape[:-1]):
        s = seg[idx]
        for a in np.flatnonzero(np.diff(s)) + 1:
            if s[a] != 0:
                out[idx][a:a + HEAD_TOKENS] = s[a:a + HEAD_TOKENS] == s[a]
    return out


def first_segment(seg) -> np.ndarray:
    """(..., S) bool: the tokens of each row's first segment."""
    seg = np.asarray(seg)
    return np.cumsum(np.diff(seg, prepend=seg[..., :1], axis=-1) != 0, axis=-1) == 0


class Program(_base.Program):
    """``dflop_train.Program`` on the hybrid; ``no_reset`` rebuilds its step
    on the configuration without segment restarts.  The first step's batch
    also gives ``seg_leak`` from the seed's weights, before the step."""

    def __init__(self, cell: dict, seed: int, device, fault: str | None = None):
        super().__init__(cell, seed, device, None if fault in OWN_FAULTS else fault)
        from repro_torch.models.model import FwdCtx
        from repro_torch.train import optim, step
        if fault == "no_reset":
            self.mc = hybrid.port_config(cell["config"], self.m, segment_reset=False)
            self.step_fn = step.make_train_step(self.mc, optim.AdamWConfig(**self.opt_cfg),
                                                ctx=FwdCtx())
        self.unplant = _bwd_leak() if fault == "bwd_leak" else None
        inner = self.step_fn
        self.seg_leak = self.seg_leak_grad = None

        def first(params, opt, batch, lr):
            if self.seg_leak is None:
                self.seg_leak = self.leak(params, batch)
                self.seg_leak_grad = self.leak_grad(params, batch)
            return inner(params, opt, batch, lr)

        self.step_fn = first

    def leak(self, params, batch) -> float:
        """``seg_leak`` of one batch (on the device, leading microbatch
        axis) at ``params``."""
        from repro_torch.models import model
        from repro_torch.models.model import FwdCtx
        seg = batch["segment_ids"].cpu().numpy()
        heads = head_mask(seg)
        tokens = batch["tokens"]
        moved = torch.where(torch.as_tensor(first_segment(seg), device=tokens.device),
                            (tokens + 1) % self.m.vocab, tokens)
        pos = batch.get("positions")
        ctx, worst = FwdCtx(return_hidden=True), 0.0
        with torch.no_grad():
            for i in range(tokens.shape[0]):
                if not heads[i].any():
                    continue
                kw = {"positions": None if pos is None else pos[i],
                      "segment_ids": batch["segment_ids"][i], "ctx": ctx}
                h0 = model.forward(params, self.mc, tokens=tokens[i], **kw)[0].float()
                h1 = model.forward(params, self.mc, tokens=moved[i], **kw)[0].float()
                gap = (torch.linalg.vector_norm(h1 - h0, dim=-1)
                       / torch.linalg.vector_norm(h0, dim=-1))
                worst = max(worst, float(gap[torch.as_tensor(heads[i], device=gap.device)].max()))
        return worst

    def leak_grad(self, params, batch) -> float:
        """``seg_leak_grad`` of one batch (on the device, leading
        microbatch axis) at ``params``."""
        from repro_torch.common.types import torch_dtype
        from repro_torch.models import model
        from repro_torch.models.layers import embed
        from repro_torch.models.model import FwdCtx
        from repro_torch.train.loss import masked_cross_entropy
        seg = batch["segment_ids"].cpu().numpy()
        firsts = first_segment(seg)
        laters = ~firsts & (seg > 0)
        pos = batch.get("positions")
        worst = 0.0
        for i in range(seg.shape[0]):
            if not laters[i].any():
                continue
            first = torch.as_tensor(firsts[i], device=self.dev)
            labels, seg_i = batch["labels"][i], batch["segment_ids"][i]
            x0 = embed.encode(params["embed"], batch["tokens"][i], torch_dtype(self.mc.dtype))
            x0 = x0.detach().float().requires_grad_(True)

            def grad_of(keep):
                mask = (labels >= 0) & keep
                with torch.enable_grad():
                    logits = model.forward(params, self.mc, embeds=x0, segment_ids=seg_i,
                                           positions=None if pos is None else pos[i],
                                           ctx=FwdCtx())[0]
                    loss = masked_cross_entropy(logits, labels, mask) * mask.sum()
                    (g,) = torch.autograd.grad(loss, x0)
                return torch.linalg.vector_norm(g[first].float())

            later = grad_of(torch.as_tensor(laters[i], device=self.dev))
            whole = grad_of(torch.ones_like(first))
            worst = max(worst, float(later / whole))
        return worst

    def check_steps(self) -> dict:
        out = super().check_steps()
        out["seg_leak"], out["seg_leak_grad"] = self.seg_leak, self.seg_leak_grad
        return out

    def close(self):
        if self.unplant is not None:
            self.unplant()
        super().close()


OWN_FAULTS = ("no_reset", "bwd_leak")


def _bwd_leak():
    """Plant ``bwd_leak``: K5 and its plain version take no restart words
    (the forward keeps them).  Returns what takes the fault out again."""
    from repro_torch.kernels import mamba_scan
    sound = {n: getattr(mamba_scan, n) for n in ("scan_bwd", "bwd_plain")}
    for name, f in sound.items():
        setattr(mamba_scan, name, lambda *a, _f=f: _f(*a[:9], None))
    return lambda: [setattr(mamba_scan, n, f) for n, f in sound.items()]


def reference_readings(cell: dict, seed: int, batches: list, device, *, compute=None,
                       state=None, fault=None) -> dict:
    """``dflop_train.reference_readings``; its ``seg_leak`` and
    ``seg_leak_grad`` are 0, as each segment runs alone."""
    out = _base_reference_readings(cell, seed, batches, device, compute=compute, state=state,
                                   fault=fault)
    out["seg_leak"] = out["seg_leak_grad"] = 0.0
    return out


def compare(prog: dict, ref: dict) -> dict:
    """``dflop_train.compare``, ``grad1_dense``, and the gaps of
    ``seg_leak`` and ``seg_leak_grad`` to the reference's."""
    out = _base_compare(prog, ref)
    out["grad1_dense"] = _base.worst_leaf_gap(prog["grad1"], ref["grad1"],
                                              keep=lambda k: k.split(".")[-1] not in MIXER)
    for k in ("seg_leak", "seg_leak_grad"):
        out[k] = abs(prog[k] - ref[k])
    return out


MIXER = frozenset(hybrid.MIXER_LEAVES)


def run(cell: dict, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_start: float | None = None, fault: str | None = None) -> dict:
    """One benchmark run of the hybrid cell (``dflop_train.run``)."""
    return _base.run(cell, seed, seconds, trace, device=device, t_start=t_start, fault=fault)


_base_reference_readings, _base_compare = _base.reference_readings, _base.compare
_base.Program, _base.reference_readings, _base.compare = Program, reference_readings, compare
