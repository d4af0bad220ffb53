#!/usr/bin/env python3
"""Hold the Mamba scan backward K5 of this tree against its plain version
and, optionally, against another build of ``mamba_scan.cu``, on one NVIDIA
card.

    python3 tools/mamba_ab.py [--baseline path/to/mamba_scan.cu] [--sass]

Builds ``src/repro_torch/kernels/csrc/mamba_scan.cu`` and prints the
``-Xptxas -v`` lines of its K5 (``bwd_kernel``: registers, stack frame,
spills), then:

- at Jamba's scan shape (B 2, S 4096, di 8192, N 16, bf16, the model's dt,
  A and D) and at small edge cases (fp32 and bf16: prime lengths, S 1 and
  5, di 36 and 300, B 3), feeds K5 the chunk-initial states of this tree's
  K4 and holds du, ddt and the dB, dC, dA, dD partials against
  ``bwd_plain`` (relative to each plain output: 1e-4 max|err|, 1e-5
  ||err||, in both types: K5's outputs are fp32 and both sides compute in
  fp32 from the same inputs), and requires two runs on the same inputs to
  be bitwise equal;
- with ``--baseline`` (typically the parent commit's file, unpacked with
  ``git archive`` into a directory git ignores), builds that source with
  the same flags, prints its K5 ptxas lines, holds it against ``bwd_plain``
  in the same cases, and times K5 of both builds at Jamba's shape in turns:
  baseline, this tree, this tree, baseline (CUDA events, ``_ab.ITERS``
  launches each);
- without it, times this tree's K5 there;
- with ``--sass``, prints for each build the static instructions of K5's
  bf16 kernel (16-byte copies, the one Jamba runs) between its first and
  last barrier, the chunk loop's body, by opcode (``cuobjdump -sass``).

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

# (max|err| / max|plain|, ||err|| / ||plain||) of each output, bf16 and fp32
TOL = (1e-4, 1e-5)
NAMES = ("du", "ddt", "dB", "dC", "dA", "dD")


def k5_ptxas(lines):
    """Each bwd_kernel instantiation (its template arguments, mangled) with
    its stack/spill and register lines."""
    out = []
    for i, ln in enumerate(lines):
        m = re.search(r"bwd_kernelI(\w+?)EEv", ln)
        if "Compiling entry" in ln and m:
            out.append(" | ".join([f"bwd_kernel<{m.group(1)}>"] + [
                x.strip() for x in lines[i + 1:i + 4] if "stack frame" in x or "registers" in x]))
        elif "arning" in ln:
            out.append(ln.strip())
    return out


def k5_sass(so, cuobjdump):
    """Opcode counts of K5's bf16 kernel (``bwd_kernel<bf16, 16, true>``, or
    a build's ``bwd_kernel<bf16, 16>``) between its first and last barrier,
    from ``cuobjdump -sass`` of the library ``so``."""
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*Function : ", txt)[1:]:
        if re.search(r"bwd_kernelI13__nv_bfloat16Li16E(?:Lb1E)?EEv", f.split("\n", 1)[0]):
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", f)
            bars = [i for i, o in enumerate(ops) if o == "BAR"]
            return collections.Counter(ops[bars[0]:bars[-1]])
    return collections.Counter()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another mamba_scan.cu to compare with")
    ap.add_argument("--sass", action="store_true",
                    help="print K5's instructions a chunk by opcode for each build")
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
        for ln in k5_ptxas(ls):
            print(f"ptxas {which}", ln, flush=True)
    paths = {which: lib._name for which, lib in libs.items()}

    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
        for which, so in paths.items():
            c = k5_sass(so, cuobjdump)
            n = sum(c.values())
            print(f"sass {which}: {n} static instructions between the first and last "
                  f"barrier ({n / 16:.1f} a step where the 16-step loops are unrolled, as "
                  f"in this tree's K5); " + ", ".join(f"{k} {v}" for k, v in c.most_common(16)),
                  flush=True)

    def use(which):
        build.use("mamba_scan", libs[which])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def case(B, S, di, dtype, path=False):
        """K5's arguments; h_init from this tree's K4.  At the path shape dt,
        A and D are the model's: softplus(. - 4), -(1..16), 1."""
        N = mamba_scan.D_STATE
        u = rnd(B, S, di).to(dtype)
        dt = torch.nn.functional.softplus(rnd(B, S, di) - (4 if path else 1)).to(dtype)
        A = (-torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(di, N).contiguous()
             if path else -torch.exp(rnd(di, N) * 0.3))
        D = torch.ones(di, device=dev) if path else rnd(di)
        Bt, Ct, dy = rnd(B, S, N).to(dtype), rnd(B, S, N).to(dtype), rnd(B, S, di).to(dtype)
        chunk = min(mamba_scan.CHUNK, S)
        use("new")
        _, h_init = mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, chunk)
        return (u, dt, Bt, Ct, A, D, h_init, dy, chunk)

    cases = {"jamba/bf16": (2, 4096, 8192, torch.bfloat16, True)}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases.update({f"prime_S257_B2_di300/{tag}": (2, 257, 300, dtype),
                      f"S97_B3_di130/{tag}": (3, 97, 130, dtype),
                      f"S1_di36/{tag}": (1, 1, 36, dtype),
                      f"S5_B3_di36/{tag}": (3, 5, 36, dtype),
                      f"S40_di256/{tag}": (1, 40, 256, dtype)})

    ok_all = True
    for name, spec in cases.items():
        a = case(*spec)
        t_max, t_rel = TOL
        chunk = a[-1]
        # the plain version takes inputs padded to a chunk multiple (dt = 0)
        S = a[0].shape[1]
        S_p = -(-S // chunk) * chunk
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, S_p - S))  # noqa: E731
        u, dt, Bt, Ct, A, D, h_init, dy, _ = a
        plain = mamba_scan.bwd_plain(pad(u), pad(dt), pad(Bt), pad(Ct), A, D, h_init,
                                     pad(dy), chunk)
        plain = [x[:, :S] for x in plain[:2]] + [x[:, :, :S] for x in plain[2:4]] + \
            list(plain[4:])
        for which in libs:
            use(which)
            runs = [mamba_scan.scan_bwd(*a) for _ in range(2)]
            torch.cuda.synchronize()
            errs = []
            for nm, got, ref in zip(NAMES, runs[0], plain):
                d, ref = got.float() - ref.float(), ref.float()
                errs.append((nm, d.abs().max().item() / max(ref.abs().max().item(), 1e-30),
                             (d.norm() / max(ref.norm(), 1e-30)).item()))
            ok = all(mx <= t_max and rel <= t_rel for _, mx, rel in errs)
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            ok_all &= ok and same
            print(f"{name}: K5 {which} vs plain {'OK' if ok else 'FAIL'} " + ", ".join(
                f"{nm} {mx:.2e}/{rel:.2e}" for nm, mx, rel in errs)
                + f" (max|err|/max|plain|, ||err||/||plain||); twice: "
                f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
        if name == "jamba/bf16":
            times = _ab.in_turns("mamba_scan", libs,
                                 lambda: _ab.cuda_ms(lambda: mamba_scan.scan_bwd(*a)))
            print(f"{name}: K5 ms, " + ", ".join(f"{w} {ms:.4f}" for w, ms in times), flush=True)
        del a, plain
        torch.cuda.empty_cache()
    print(_ab.card())
    print("ALL_OK" if ok_all else "SOME_FAIL")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
