#!/usr/bin/env python3
"""Hold the Mamba scan kernels K4 (forward) and K5 (backward) of this tree
against their plain versions and, optionally, against another build of
``mamba_scan.cu``, on one NVIDIA card.

    python3 tools/mamba_ab.py [--baseline path/to/mamba_scan.cu]
                              [--path-only] [--sass] [--step]

Builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` and prints the
``-Xptxas -v`` lines of its K4 (``fwd_kernel``) and K5 (``bwd_kernel``):
registers, stack frame, spills.  Then:

- K4: at Jamba's scan shape (B 2, S 4096, di 8192, N 16, bf16, the model's
  dt, A and D; chunk ``CHUNK``) and at edge cases (fp32 and bf16: S at
  ``K4_TILE`` - 1, + 1 and 2 ``K4_TILE`` + 1, chunks 1, 3, 8 and 16, S 1 and
  5, B 3, di 36 and 300, and u, dt as views one element off 16-byte
  alignment; the last three take K4's plain-load path), holds y (at the
  type's tolerance) and h_init (at fp32's, in both types: both sides compute
  the state in fp32) against ``fwd_plain``, requires two runs to be bitwise
  equal, and requires h_init at chunk 1, taken every 16th step, to be
  bitwise equal to h_init at chunk 16 (the state does not depend on the
  chunk);
- K5: at Jamba's shape and edge cases (S 1, 5, 97, 257; di 36, 130, 256,
  300; B 3), fed the chunk-initial states of this tree's K4, holds du, ddt
  and the dB, dC, dA, dD partials against ``bwd_plain`` (fp32's tolerance in
  both types: K5's outputs are fp32) and requires two runs bitwise equal;
- with ``--baseline`` (typically the parent commit's file, unpacked with
  ``git archive`` into a directory git ignores, or an edited copy of this
  tree's file there: a variant), builds that source with the same flags,
  holds it in the same cases, and times K4 and
  K5 of both builds at Jamba's shape in turns: baseline, this tree, this
  tree, baseline (CUDA events, ``_ab.ITERS`` launches each); without it,
  times this tree's; ``--path-only`` skips the edge cases (a variant's
  timing);
- with ``--sass``, prints for each build K4's bf16 kernel (16-byte copies,
  the one Jamba runs): the innermost loop that holds its exponentials, by
  opcode, and its instructions per exponential; and K5's bf16 kernel between
  its first and last barrier, by opcode (``cuobjdump -sass``);
- with ``--step`` and a baseline, times Jamba's training step (8 layers, no
  experts, 2 microbatches x 2 rows x 4096 tokens, AdamW, random tokens: the
  scan shapes do not depend on them) with each build's kernels in turns
  (host clock around 3 steps that end in ``torch.cuda.synchronize()``, after
  one).

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
# and K4's y in bf16 (one bf16 rounding on each side)
TOL = (1e-4, 1e-5)
TOL_BF16 = (2e-2, 1e-2)
K5_NAMES = ("du", "ddt", "dB", "dC", "dA", "dD")
# each kernel's entry in ptxas's lines, mangled: (symbol, template arguments)
SYMBOL = {"K4": re.compile(r"(fwd_kernel)I(\w+?)EEv"),
          "K5": re.compile(r"(bwd_kernel)I(\w+?)EEv")}
# the bf16 instantiation each build's SASS is read for (16-byte copies; a
# build before the VEC argument has none)
SASS_FN = {"K4": re.compile(r"10fwd_kernelI13__nv_bfloat16Li16E(?:Lb1E)?EEv"),
           "K5": re.compile(r"10bwd_kernelI13__nv_bfloat16Li16E(?:Lb1E)?EEv")}
SASS_OP = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);")


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


def sass_of(kn, so, cuobjdump):
    """(address, opcode, operands) of each instruction of kernel ``kn``'s
    bf16 instantiation, and its labels' addresses, from ``cuobjdump -sass``
    of the library ``so``."""
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*Function : ", txt)[1:]:
        if SASS_FN[kn].search(f.split("\n", 1)[0]):
            ins, labels, pending = [], {}, []
            for ln in f.splitlines():
                lab = re.match(r"\s*(\.L_x_\d+):", ln)
                if lab:
                    pending.append(lab.group(1))
                m = SASS_OP.search(ln)
                if m:
                    addr = int(m.group(1), 16)
                    labels.update({p: addr for p in pending})
                    pending = []
                    ins.append((addr, m.group(2), m.group(3)))
            return ins, labels
    return [], {}


def k4_loop_counts(ins, labels):
    """Opcode counts of the smallest loop (a backward branch's range) that
    holds exponentials (MUFU), or of the whole function if none is found."""
    loops = []
    for addr, op, rest in ins:
        if op == "BRA":
            m = re.search(r"(\.L_x_\d+)", rest) or re.search(r"0x([0-9a-f]+)", rest)
            if m:
                target = labels.get(m.group(1)) if m.group(1).startswith(".L") \
                    else int(m.group(1), 16)
                if target is not None and target <= addr:
                    loops.append((target, addr))
    with_mufu = [(lo, hi) for lo, hi in loops
                 if any(op == "MUFU" and lo <= a <= hi for a, op, _ in ins)]
    if not with_mufu:
        return "whole function", collections.Counter(op for _, op, _ in ins)
    lo, hi = min(with_mufu, key=lambda r: r[1] - r[0])
    return (f"loop {lo:#x}-{hi:#x}",
            collections.Counter(op for a, op, _ in ins if lo <= a <= hi))


def k5_counts(ins):
    """Opcode counts of K5 between its first and last barrier."""
    ops = [op for _, op, _ in ins]
    bars = [i for i, o in enumerate(ops) if o == "BAR"]
    return collections.Counter(ops[bars[0]:bars[-1]] if bars else ops)


def rel_err(got, ref):
    d, ref = got.float() - ref.float(), ref.float()
    return (d.abs().max().item() / max(ref.abs().max().item(), 1e-30),
            (d.norm() / max(ref.norm(), 1e-30)).item())


def step_turns(libs) -> None:
    """Jamba's training step at 8 layers (no experts) with each build of
    ``mamba_scan`` in turns (baseline, new, new, baseline): seconds a step,
    the mean of 3 after one."""
    import dataclasses
    import time

    import numpy as np
    import torch

    from repro_torch.configs import jamba_v0_1_52b
    from repro_torch.models import model
    from repro_torch.models.model import FwdCtx
    from repro_torch.train import optim, step

    cfg = dataclasses.replace(jamba_v0_1_52b.CFG, n_layers=8, ffn_pattern=("dense",))
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

    out = _ab.in_turns("mamba_scan", libs, seconds)
    print("jamba train step (8 layers, no experts) s, in turns: "
          + ", ".join(f"{w} {t:.4f}" for w, t in out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another mamba_scan.cu to compare with")
    ap.add_argument("--path-only", action="store_true",
                    help="only Jamba's shape (a variant's timing), no edge cases")
    ap.add_argument("--sass", action="store_true",
                    help="print the kernels' instructions by opcode for each build")
    ap.add_argument("--step", action="store_true",
                    help="time Jamba's training step with each build, in turns")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("mamba_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, mamba_scan

    libs, lines = _ab.libraries("mamba_scan", args.baseline)
    if not lines["new"]:
        print("ptxas new: loaded from the build cache; its ptxas lines are the build's "
              "that made it (chip_smoke.py's [build] lines)", flush=True)
    for which, ls in lines.items():
        for ln in [x for kn in ("K4", "K5") for x in kernel_ptxas(kn, ls)] + [
                x.strip() for x in ls if "arning" in x]:
            print(f"ptxas {which}", ln, flush=True)
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
        for which, lib in libs.items():
            where, c = k4_loop_counts(*sass_of("K4", lib._name, cuobjdump))
            n, n_exp = sum(c.values()), c.get("MUFU", 0)
            print(f"sass {which} K4: {where}: {n} static instructions, {n_exp} MUFU "
                  f"({n / max(n_exp, 1):.2f} a MUFU); "
                  + ", ".join(f"{k} {v}" for k, v in c.most_common(24)), flush=True)
            c = k5_counts(sass_of("K5", lib._name, cuobjdump)[0])
            print(f"sass {which} K5: {sum(c.values())} static instructions between the first "
                  f"and last barrier; " + ", ".join(f"{k} {v}" for k, v in c.most_common(16)),
                  flush=True)

    def use(which):
        build.use("mamba_scan", libs[which])

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

    def case(B, S, di, dtype, path=False):
        """u, dt, B_t, C_t, A, D and dy.  At the path shape dt, A and D are
        the model's: softplus(. - 4), -(1..16), 1."""
        N = mamba_scan.D_STATE
        u = rnd(B, S, di).to(dtype)
        dt = torch.nn.functional.softplus(rnd(B, S, di) - (4 if path else 1)).to(dtype)
        A = (-torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(di, N).contiguous()
             if path else -torch.exp(rnd(di, N) * 0.3))
        D = torch.ones(di, device=dev) if path else rnd(di)
        Bt, Ct, dy = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype), rnd(B, S, di).to(dtype)
        return u, dt, Bt, Ct, A, D, dy

    def padder(chunk, S):
        S_p = -(-S // chunk) * chunk
        return lambda t: torch.nn.functional.pad(t, (0, 0, 0, S_p - S))

    def in_turns(name, fn):
        out = _ab.in_turns("mamba_scan", libs, lambda: _ab.cuda_ms(fn))
        print(f"{name}: ms, in turns: " + ", ".join(f"{w} {ms:.4f}" for w, ms in out),
              flush=True)

    C, TILE = mamba_scan.CHUNK, mamba_scan.K4_TILE
    # name -> ((B, S, di, dtype[, path]), chunk, u and dt unaligned)
    path = {"jamba/bf16": ((2, 4096, 8192, torch.bfloat16, True), C, False)}
    common, k4_only = {}, {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        common.update({f"prime_S257_B2_di300/{tag}": ((2, 257, 300, dtype), C, False),
                       f"S97_B3_di130/{tag}": ((3, 97, 130, dtype), C, False),
                       f"S1_di36/{tag}": ((1, 1, 36, dtype), C, False),
                       f"S5_B3_di36/{tag}": ((3, 5, 36, dtype), C, False),
                       f"S40_di256/{tag}": ((1, 40, 256, dtype), C, False)})
        k4_only.update({f"S{TILE - 1}/{tag}": ((2, TILE - 1, 256, dtype), C, False),
                        f"S{TILE + 1}_chunk1/{tag}": ((1, TILE + 1, 256, dtype), 1, False),
                        f"S{2 * TILE + 1}_chunk3_B3/{tag}": ((3, 2 * TILE + 1, 128, dtype), 3,
                                                             False),
                        f"S{2 * TILE + 1}_chunk8_offset/{tag}": ((2, 2 * TILE + 1, 384, dtype),
                                                                 8, True),
                        f"S{TILE + 1}_offset_di300/{tag}": ((1, TILE + 1, 300, dtype), C,
                                                            True)})
    if args.path_only:
        common, k4_only = {}, {}
    ok_all = True

    # K4 ---------------------------------------------------------------------
    for name, (spec, chunk, offset) in {**path, **common, **k4_only}.items():
        u, dt, Bt, Ct, A, D, _ = case(*spec)
        S = u.shape[1]
        c = min(chunk, S)
        pad = padder(c, S)
        y_p, i_p = mamba_scan.fwd_plain(pad(u), pad(dt), pad(Bt), pad(Ct), A, D, c)
        ku, kdt = (off_view(u), off_view(dt)) if offset else (u, dt)
        for which in libs:
            use(which)
            runs = [mamba_scan.scan_fwd(ku, kdt, Bt, Ct, A, D, c) for _ in range(2)]
            torch.cuda.synchronize()
            errs = [(nm, *rel_err(got, want)) for nm, got, want in
                    zip(("y", "h_init"), runs[0], (y_p[:, :S], i_p))]
            tol_y = TOL_BF16 if u.dtype == torch.bfloat16 else TOL
            ok = all(mx <= t[0] and rel <= t[1] for (_, mx, rel), t in zip(errs, (tol_y, TOL)))
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            # the state does not depend on the chunk: chunk 1's h_init every
            # 16th step is chunk 16's, bitwise
            _, h1 = mamba_scan.scan_fwd(ku, kdt, Bt, Ct, A, D, 1)
            _, h16 = mamba_scan.scan_fwd(ku, kdt, Bt, Ct, A, D, 16)
            chunks = torch.equal(h1[:, ::16], h16)
            ok_all &= ok and same and chunks
            print(f"{name}: K4 {which} chunk {c} vs plain {'OK' if ok else 'FAIL'} "
                  + ", ".join(f"{nm} {mx:.2e}/{rel:.2e}" for nm, mx, rel in errs)
                  + f" (max|err|/max|plain|, ||err||/||plain||); twice: "
                  f"{'bitwise equal' if same else 'DIFFER'}; h_init chunk 1 every 16th "
                  f"step vs chunk 16: {'bitwise equal' if chunks else 'DIFFER'}", flush=True)
            del runs, h1, h16
        use("new")
        if name in path:
            in_turns(f"{name}: K4 chunk {c}", lambda: mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c))
        del u, dt, Bt, Ct, A, D, y_p, i_p, ku, kdt
        torch.cuda.empty_cache()

    # K5 ---------------------------------------------------------------------
    for name, (spec, _, _) in {**path, **common}.items():
        u, dt, Bt, Ct, A, D, dy = case(*spec)
        S = u.shape[1]
        c = min(C, S)
        pad = padder(c, S)
        use("new")
        _, h_init = mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c)      # K4 of this tree
        a = (u, dt, Bt, Ct, A, D, h_init, dy, c)
        plain = mamba_scan.bwd_plain(pad(u), pad(dt), pad(Bt), pad(Ct), A, D, h_init,
                                     pad(dy), c)
        plain = [x[:, :S] for x in plain[:2]] + [x[:, :, :S] for x in plain[2:4]] + \
            list(plain[4:])
        for which in libs:
            use(which)
            runs = [mamba_scan.scan_bwd(*a) for _ in range(2)]
            torch.cuda.synchronize()
            errs = [(nm, *rel_err(got, want)) for nm, got, want in zip(K5_NAMES, runs[0], plain)]
            ok = all(mx <= TOL[0] and rel <= TOL[1] for _, mx, rel in errs)
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            ok_all &= ok and same
            print(f"{name}: K5 {which} vs plain {'OK' if ok else 'FAIL'} " + ", ".join(
                f"{nm} {mx:.2e}/{rel:.2e}" for nm, mx, rel in errs)
                + f" (max|err|/max|plain|, ||err||/||plain||); twice: "
                f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
            del runs
        use("new")
        if name in path:
            in_turns(f"{name}: K5", lambda: mamba_scan.scan_bwd(*a))
        del a, plain, h_init, u, dt, Bt, Ct, A, D, dy
        torch.cuda.empty_cache()
    if args.step and "baseline" in libs:
        step_turns(libs)
    print(_ab.card())
    print("ALL_OK" if ok_all else "SOME_FAIL")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
