#!/usr/bin/env python3
"""Hold the RWKV6 scan kernels K6 (forward) and K7 (backward) of this tree
against their plain versions and, optionally, against another build of
``rwkv6_scan.cu``, on one NVIDIA card.

    python3 tools/rwkv6_ab.py [--baseline path/to/rwkv6_scan.cu]
                              [--path-only] [--sass] [--step]

Builds ``src/repro_torch/kernels/csrc/rwkv6_scan.cu`` and prints the
``-Xptxas -v`` lines of its K6 (``wkv6_fwd_kernel``; a parent's
``fwd_kernel``) and K7 (``wkv6_bwd_kernel``): registers, stack frame,
spills.  Then, each kernel at ``rwkv6_scan.CHUNK`` (any chunk at most
``S``):

- K6: at RWKV6-7B's WKV shape (B 2, H 64, S 4096, M 64, bf16, the model's
  decay ``exp(-exp(dec))`` with dec in [-6, -1]) and at edge cases (fp32
  and bf16: S 1 and 5, S one past the chunk, a prime S with B 2, B 3, M 32,
  S at ``K6_TILE`` - 1, + 1 and 2 ``K6_TILE`` + 1, chunks 1, 3 and 8, and r,
  k, v as views one element off 16-byte alignment, which take K6's
  plain-load path), holds y (at the type's tolerance), s_final and s_init
  (fp32's, in both types: both sides compute them in fp32) against
  ``fwd_plain``, requires two runs to be bitwise equal, and with a baseline
  requires s_final and s_init bitwise equal to the baseline's (both update
  each state element as fmaf(w_i, S_ij, k_i v_j); y sums in another order
  and is only reported);
- K7: in the same shapes (without the K6-only ones), fed the chunk-initial
  states of this tree's K6, holds dr, dk, dv, dw and the du partial
  against ``bwd_plain`` (fp32's tolerance in both types: K7's outputs are
  fp32), and requires two runs to be bitwise equal;
- with ``--baseline`` (typically the parent commit's file, unpacked with
  ``git archive`` into a directory git ignores, or an edited copy of this
  one: a variant or a probe), builds that source with the same flags and
  times each kernel of both builds at RWKV6-7B's shape in turns: baseline,
  this tree, this tree, baseline (CUDA events, ``_ab.ITERS`` launches
  each); without it, times this tree's; ``--path-only`` skips the edge
  cases (a variant's timing);
- with ``--sass``, prints for each build the static instructions of K6's and
  K7's bf16 M 64 kernels by opcode (``cuobjdump -sass``);
- with ``--step`` and a baseline, times RWKV6-7B's training step (8 layers,
  2 microbatches x 2 rows x 4096 tokens, AdamW, random tokens: the WKV
  shapes do not depend on them) with each build's kernels in turns (host
  clock around 3 steps that end in ``torch.cuda.synchronize()``, after one).

Prints the card's name and power limit, then ALL_OK or SOME_FAIL; exits
non-zero on any disagreement.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

import _ab

# (max|err| / max|plain|, ||err|| / ||plain||): fp32 outputs in both types,
# and K6's y in bf16 (one bf16 rounding on each side)
TOL = (1e-4, 1e-5)
TOL_BF16 = (2e-2, 1e-2)
K7_NAMES = ("dr", "dk", "dv", "dw", "du")
# each kernel's entry in ptxas's lines, mangled: (symbol, template arguments)
SYMBOL = {"K6": re.compile(r"((?:wkv6_)?fwd_kernel)I(\w+?)EEv"),
          "K7": re.compile(r"((?:wkv6_)?bwd_kernel)I(\w+?)EEv")}
# the bf16 M 64 instantiation each build's SASS is counted for (bulk copies)
SASS_FN = {"K6": re.compile(r"15wkv6_fwd_kernelI13__nv_bfloat16Li64ELb1EEEv"
                            r"|10fwd_kernelI13__nv_bfloat16Li64EEEv"),
           "K7": re.compile(r"15wkv6_bwd_kernelI13__nv_bfloat16Li64ELb1EEEv"
                            r"|10bwd_kernelI13__nv_bfloat16Li64EEEv")}


def kernel_ptxas(kn, lines):
    """Each instantiation of kernel ``kn`` with its stack/spill and register
    lines."""
    out = []
    for i, ln in enumerate(lines):
        m = SYMBOL[kn].search(ln)
        if "Compiling entry" in ln and m:
            out.append(" | ".join([f"{kn} {m.group(1)}<{m.group(2)}>"] + [
                x.strip() for x in lines[i + 1:i + 4] if "stack frame" in x or "registers" in x]))
    return out


def kernel_sass(kn, so, cuobjdump):
    """Opcode counts of kernel ``kn``'s bf16 M 64 instantiation, the whole
    function, from ``cuobjdump -sass`` of the library ``so``."""
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*Function : ", txt)[1:]:
        if SASS_FN[kn].search(f.split("\n", 1)[0]):
            return collections.Counter(
                re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", f))
    return collections.Counter()


def rel_err(got, ref):
    d, ref = got.float() - ref.float(), ref.float()
    return (d.abs().max().item() / max(ref.abs().max().item(), 1e-30),
            (d.norm() / max(ref.norm(), 1e-30)).item())


def step_turns(libs) -> None:
    """RWKV6-7B's training step at 8 layers with each build of
    ``rwkv6_scan`` in turns (baseline, new, new, baseline): seconds a step,
    the mean of 3 after one."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from repro_torch.configs import rwkv6_7b
    from repro_torch.models import model
    from repro_torch.models.model import FwdCtx
    from repro_torch.train import optim, step

    cfg = dataclasses.replace(rwkv6_7b.CFG, n_layers=8)
    shape = (2, 2, 4096)
    rng = np.random.default_rng(0)
    batch = step.as_tensors({
        "tokens": rng.integers(0, cfg.vocab_size, shape),
        "labels": rng.integers(0, cfg.vocab_size, shape),
        "segment_ids": np.ones(shape, np.int32),
        "positions": np.broadcast_to(np.arange(shape[2]), shape).copy()}, device="cuda")
    params = model.init(cfg, seed=0, device=torch.device("cuda"))
    opt = optim.adamw_init(params)
    train_step = step.make_train_step(cfg, optim.AdamWConfig(), ctx=FwdCtx())
    state = {"params": params, "opt": opt}

    def seconds():
        for i in range(4):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state["params"], state["opt"], m = train_step(state["params"], state["opt"],
                                                          batch, 3e-4)
        m["loss"].item()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3

    out = _ab.in_turns("rwkv6_scan", libs, seconds)
    print("rwkv6-7b train step (8 layers) s, in turns: "
          + ", ".join(f"{w} {t:.4f}" for w, t in out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another rwkv6_scan.cu to compare with")
    ap.add_argument("--path-only", action="store_true",
                    help="only RWKV6-7B's shape (a variant's timing), no edge cases")
    ap.add_argument("--sass", action="store_true",
                    help="print the kernels' instructions by opcode for each build")
    ap.add_argument("--step", action="store_true",
                    help="time RWKV6-7B's training step with each build, in turns")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("rwkv6_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, rwkv6_scan

    libs, lines = _ab.libraries("rwkv6_scan", args.baseline)
    if not lines["new"]:
        print("ptxas new: loaded from the build cache; its ptxas lines are the build's "
              "that made it (chip_smoke.py's [build] lines)", flush=True)
    for which, ls in lines.items():
        for ln in [x for kn in ("K6", "K7") for x in kernel_ptxas(kn, ls)] + [
                x.strip() for x in ls if "arning" in x]:
            print(f"ptxas {which}", ln, flush=True)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
        for which, lib in libs.items():
            for kn in ("K6", "K7"):
                c = kernel_sass(kn, lib._name, cuobjdump)
                print(f"sass {which} {kn}: {sum(c.values())} static instructions; "
                      + ", ".join(f"{k} {v}" for k, v in c.most_common(24)), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def off_view(t):
        """``t``'s values in a contiguous view one element past a 16-byte
        aligned allocation."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16
        return out

    def case(B, H, S, M, dtype, final_cot, path=False, offset=False):
        r, k, v, dy = (rnd(B, H, S, M).to(dtype) for _ in range(4))
        w = (torch.exp(-torch.exp(-6 + 5 * torch.rand(B, H, S, M, generator=gen, device=dev)))
             if path else torch.sigmoid(rnd(B, H, S, M)))
        u = rnd(H, M) * 0.1
        ds = rnd(B, H, M, M) if final_cot else torch.zeros(B, H, M, M, device=dev)
        if offset:
            r, k, v, dy = (off_view(t) for t in (r, k, v, dy))
        return r, k, v, w, u, dy, ds

    def pad_to(chunk, S):
        S_p = -(-S // chunk) * chunk
        return lambda t, x=0.0: torch.nn.functional.pad(t, (0, 0, 0, S_p - S), value=x)

    def plain_fwd(r, k, v, w, u, chunk):
        """fwd_plain on the inputs padded to a chunk multiple (identity
        steps), y cut back to S."""
        S = r.shape[2]
        pad = pad_to(chunk, S)
        y, s_fin, s_init = rwkv6_scan.fwd_plain(pad(r), pad(k), pad(v), pad(w, 1.0), u, chunk)
        return y[:, :, :S], s_fin, s_init

    def plain_bwd(r, k, v, w, u, s_init, dy, ds, chunk):
        """bwd_plain on the inputs padded to a chunk multiple, cut back to S."""
        S = r.shape[2]
        pad = pad_to(chunk, S)
        out = rwkv6_scan.bwd_plain(pad(r), pad(k), pad(v), pad(w, 1.0), u, s_init, pad(dy),
                                   ds, chunk)
        return [x[:, :, :S] for x in out[:4]] + [out[4]]

    def in_turns(name, fn):
        """``fn`` timed with each build in turns: baseline, new, new,
        baseline (new alone without a baseline)."""
        out = _ab.in_turns("rwkv6_scan", libs, lambda: _ab.cuda_ms(fn))
        print(f"{name}: ms, in turns: " + ", ".join(f"{w} {ms:.4f}" for w, ms in out),
              flush=True)

    C, TILE = rwkv6_scan.CHUNK, rwkv6_scan.K6_TILE
    path = {"rwkv6-7b/bf16": ((2, 64, 4096, 64, torch.bfloat16, False, True), C)}
    common, k6_only = {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        common.update({f"S1_ds/{tag}": ((1, 2, 1, 64, dtype, True), C),
                       f"S5_B3/{tag}": ((3, 2, 5, 64, dtype, False), C),
                       f"S{C + 1}_ds/{tag}": ((1, 3, C + 1, 64, dtype, True), C),
                       f"prime_S257_B2_ds/{tag}": ((2, 3, 257, 64, dtype, True), C),
                       f"S97_M32_ds/{tag}": ((1, 2, 97, 32, dtype, True), C),
                       f"S61_B3_offset/{tag}": ((3, 2, 61, 64, dtype, True, False, True), C)})
        k6_only.update({f"S{TILE - 1}/{tag}": ((1, 2, TILE - 1, 64, dtype, False), C),
                        f"S{TILE + 1}/{tag}": ((2, 2, TILE + 1, 64, dtype, False), C),
                        f"S{2 * TILE + 1}_M32/{tag}": ((1, 3, 2 * TILE + 1, 32, dtype, False), C),
                        f"S67_chunk1/{tag}": ((1, 2, 67, 64, dtype, False), 1),
                        f"S67_chunk3_M32/{tag}": ((2, 2, 67, 32, dtype, False), 3),
                        f"S{2 * TILE + 1}_chunk3_offset/{tag}": (
                            (1, 2, 2 * TILE + 1, 64, dtype, False, False, True), 3),
                        f"S130_chunk8/{tag}": ((2, 2, 130, 64, dtype, False), 8)})

    if args.path_only:
        common, k6_only = {}, {}
    ok_all = True

    # K6 ---------------------------------------------------------------------
    for name, (spec, chunk) in {**path, **common, **k6_only}.items():
        r, k, v, w, u, _, _ = case(*spec)
        c = min(chunk, r.shape[2])
        ref = plain_fwd(r, k, v, w, u, c)
        outs = {}
        for which in libs:
            build.use("rwkv6_scan", libs[which])
            runs = [rwkv6_scan.wkv_fwd(r, k, v, w, u, c) for _ in range(2)]
            torch.cuda.synchronize()
            errs = [(nm, *rel_err(got, want)) for nm, got, want in
                    zip(("y", "s_final", "s_init"), runs[0], ref)]
            tol_y = TOL_BF16 if r.dtype == torch.bfloat16 else TOL
            ok = all(mx <= t[0] and rel <= t[1] for (nm, mx, rel), t in
                     zip(errs, (tol_y, TOL, TOL)))
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            ok_all &= ok and same
            outs[which] = runs[0]
            print(f"{name}: K6 {which} chunk {c} vs plain {'OK' if ok else 'FAIL'} "
                  + ", ".join(f"{nm} {mx:.2e}/{rel:.2e}" for nm, mx, rel in errs)
                  + f" (max|err|/max|plain|, ||err||/||plain||); twice: "
                  f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        build.use("rwkv6_scan", libs["new"])
        if "baseline" in outs:
            states = all(torch.equal(a, b) for a, b in zip(outs["new"][1:], outs["baseline"][1:]))
            ok_all &= states
            y_diff = (outs["new"][0].float() - outs["baseline"][0].float()).abs().max()
            print(f"{name}: K6 new vs baseline: s_final, s_init "
                  f"{'bitwise equal' if states else 'DIFFER'}; y max|diff| {y_diff.item():.3e}",
                  flush=True)
        if name in path:
            in_turns(f"{name}: K6 chunk {c}", lambda: rwkv6_scan.wkv_fwd(r, k, v, w, u, c))
        del r, k, v, w, u, ref, outs, runs
        torch.cuda.empty_cache()

    # K7 ---------------------------------------------------------------------
    for name, (spec, _) in {**path, **common}.items():
        r, k, v, w, u, dy, ds = case(*spec)
        c = min(C, r.shape[2])
        _, _, s_init = rwkv6_scan.wkv_fwd(r, k, v, w, u, c)      # K6 of this tree
        a = (r, k, v, w, u, s_init, dy, ds, c)
        plain = plain_bwd(*a)
        for which in libs:
            build.use("rwkv6_scan", libs[which])
            runs = [rwkv6_scan.wkv_bwd(*a) for _ in range(2)]
            torch.cuda.synchronize()
            errs = [(nm, *rel_err(got, want)) for nm, got, want in zip(K7_NAMES, runs[0], plain)]
            ok = all(mx <= TOL[0] and rel <= TOL[1] for _, mx, rel in errs)
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            ok_all &= ok and same
            print(f"{name}: K7 {which} chunk {c} vs plain {'OK' if ok else 'FAIL'} "
                  + ", ".join(f"{nm} {mx:.2e}/{rel:.2e}" for nm, mx, rel in errs)
                  + f" (max|err|/max|plain|, ||err||/||plain||); twice: "
                  f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
            del runs
        build.use("rwkv6_scan", libs["new"])
        if name in path:
            in_turns(f"{name}: K7 chunk {c}", lambda: rwkv6_scan.wkv_bwd(*a))
        del r, k, v, w, u, dy, ds, s_init, a, plain
        torch.cuda.empty_cache()
    if args.step and "baseline" in libs:
        step_turns(libs)
    print(_ab.card())
    print("ALL_OK" if ok_all else "SOME_FAIL")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
