#!/usr/bin/env python3
"""Hold the RWKV6 scan backward K7 of this tree against its plain version
and, optionally, against another build of ``rwkv6_scan.cu``, on one NVIDIA
card.

    python3 tools/rwkv6_ab.py [--baseline path/to/rwkv6_scan.cu]
                              [--baseline-chunk 8] [--sass]

Builds ``src/repro_torch/kernels/csrc/rwkv6_scan.cu`` and prints the
``-Xptxas -v`` lines of its K7 (``wkv6_bwd_kernel``; a baseline's
``bwd_kernel``: registers, stack frame, spills), then:

- at RWKV6-7B's WKV shape (B 2, H 64, S 4096, M 64, bf16, the model's decay
  ``exp(-exp(dec))`` with dec in [-6, -1], no final-state cotangent, as
  training runs it) and at edge cases (fp32 and bf16: S 1 and 5, S one past
  the chunk, a prime S with B 2, B 3, M 32 with a final-state cotangent, and
  r, k, v, dy as views one element off 16-byte alignment, which takes K7's
  plain-load path), feeds each K7 the chunk-initial states of this tree's K6
  at that build's chunk and holds dr, dk, dv, dw and the du partial against
  ``bwd_plain`` (relative to each plain output: 1e-4 max|err|, 1e-5
  ||err||, in both types: K7's outputs are fp32 and both sides compute in
  fp32 from the same inputs), and requires two runs on the same inputs to
  be bitwise equal;
- with ``--baseline`` (typically the parent commit's file, unpacked with
  ``git archive`` into a directory git ignores), builds that source with
  the same flags, prints its K7 ptxas lines, runs it at
  ``--baseline-chunk`` (8, the most the parent's shared-memory history
  took) in the same cases, and times K7 of both builds at RWKV6-7B's shape
  in turns: baseline, this tree, this tree, baseline (CUDA events,
  ``_ab.ITERS`` launches each), this tree's K7 at ``rwkv6_scan.CHUNK``;
- without it, times this tree's K7 there;
- with ``--sass``, prints for each build the static instructions of K7's
  bf16 M 64 kernel by opcode (``cuobjdump -sass``).

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
NAMES = ("dr", "dk", "dv", "dw", "du")
K7_SYMBOL = re.compile(r"(?:wkv6_)?bwd_kernelI(\w+?)EEv")


def k7_ptxas(lines):
    """Each K7 instantiation (its template arguments, mangled) with its
    stack/spill and register lines."""
    out = []
    for i, ln in enumerate(lines):
        m = K7_SYMBOL.search(ln)
        if "Compiling entry" in ln and m:
            name = "wkv6_bwd_kernel" if "wkv6_bwd_kernel" in ln else "bwd_kernel"
            out.append(" | ".join([f"{name}<{m.group(1)}>"] + [
                x.strip() for x in lines[i + 1:i + 4] if "stack frame" in x or "registers" in x]))
        elif "arning" in ln:
            out.append(ln.strip())
    return out


def k7_sass(so, cuobjdump):
    """Opcode counts of K7's bf16 M 64 kernel (``wkv6_bwd_kernel<bf16, 64,
    true>``, or a parent's ``bwd_kernel<bf16, 64>``), the whole function,
    from ``cuobjdump -sass`` of the library ``so``."""
    txt = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    for f in re.split(r"\n\s*Function : ", txt)[1:]:
        head = f.split("\n", 1)[0]
        if re.search(r"15wkv6_bwd_kernelI13__nv_bfloat16Li64ELb1EEEv", head) or \
                re.search(r"10bwd_kernelI13__nv_bfloat16Li64EEEv", head):
            ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", f)
            return collections.Counter(ops)
    return collections.Counter()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another rwkv6_scan.cu to compare with")
    ap.add_argument("--baseline-chunk", type=int, default=8,
                    help="the chunk the baseline's K7 runs at (default 8)")
    ap.add_argument("--sass", action="store_true",
                    help="print K7's instructions by opcode for each build")
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
        for ln in k7_ptxas(ls):
            print(f"ptxas {which}", ln, flush=True)
    paths = {which: lib._name for which, lib in libs.items()}

    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
        for which, so in paths.items():
            c = k7_sass(so, cuobjdump)
            n = sum(c.values())
            print(f"sass {which}: {n} static instructions; "
                  + ", ".join(f"{k} {v}" for k, v in c.most_common(24)), flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    chunks = {"new": rwkv6_scan.CHUNK, "baseline": args.baseline_chunk}

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def off_view(t):
        """``t``'s values in a contiguous view one element past a 16-byte
        aligned allocation."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    def case(B, H, S, M, dtype, final_cot, path=False, offset=False):
        r, k, v, dy = (rnd(B, H, S, M).to(dtype) for _ in range(4))
        w = (torch.exp(-torch.exp(-6 + 5 * torch.rand(B, H, S, M, generator=gen, device=dev)))
             if path else torch.sigmoid(rnd(B, H, S, M)))
        u = rnd(H, M) * 0.1
        ds = rnd(B, H, M, M) if final_cot else torch.zeros(B, H, M, M, device=dev)
        if offset:
            r, k, v, dy = (off_view(t) for t in (r, k, v, dy))
            assert r.data_ptr() % 16
        return r, k, v, w, u, dy, ds

    def plain_bwd(r, k, v, w, u, s_init, dy, ds, chunk):
        """bwd_plain on the inputs padded to a chunk multiple (identity
        steps), cut back to S."""
        S = r.shape[2]
        S_p = -(-S // chunk) * chunk
        pad = lambda t, x=0.0: torch.nn.functional.pad(t, (0, 0, 0, S_p - S), value=x)  # noqa: E731
        out = rwkv6_scan.bwd_plain(pad(r), pad(k), pad(v), pad(w, 1.0), u, s_init, pad(dy),
                                   ds, chunk)
        return [x[:, :, :S] for x in out[:4]] + [out[4]]

    cases = {"rwkv6-7b/bf16": (2, 64, 4096, 64, torch.bfloat16, False, True)}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases.update({f"S1_ds/{tag}": (1, 2, 1, 64, dtype, True),
                      f"S5_B3/{tag}": (3, 2, 5, 64, dtype, False),
                      f"S{rwkv6_scan.CHUNK + 1}_ds/{tag}": (1, 3, rwkv6_scan.CHUNK + 1, 64,
                                                              dtype, True),
                      f"prime_S257_B2_ds/{tag}": (2, 3, 257, 64, dtype, True),
                      f"S97_M32_ds/{tag}": (1, 2, 97, 32, dtype, True),
                      f"S61_B3_offset/{tag}": (3, 2, 61, 64, dtype, True, False, True)})

    ok_all = True
    for name, spec in cases.items():
        r, k, v, w, u, dy, ds = case(*spec)
        S = r.shape[2]
        timed = {}
        for which in libs:
            c = min(chunks[which], S)
            build.use("rwkv6_scan", libs["new"])        # K6 of this tree
            _, _, s_init = rwkv6_scan.wkv_fwd(r, k, v, w, u, c)
            build.use("rwkv6_scan", libs[which])
            a = (r, k, v, w, u, s_init, dy, ds, c)
            runs = [rwkv6_scan.wkv_bwd(*a) for _ in range(2)]
            torch.cuda.synchronize()
            plain = plain_bwd(*a)
            errs = []
            for nm, got, ref in zip(NAMES, runs[0], plain):
                d, ref = got.float() - ref.float(), ref.float()
                errs.append((nm, d.abs().max().item() / max(ref.abs().max().item(), 1e-30),
                             (d.norm() / max(ref.norm(), 1e-30)).item()))
            ok = all(mx <= TOL[0] and rel <= TOL[1] for _, mx, rel in errs)
            same = all(torch.equal(x, y) for x, y in zip(*runs))
            ok_all &= ok and same
            print(f"{name}: K7 {which} chunk {c} vs plain {'OK' if ok else 'FAIL'} "
                  + ", ".join(f"{nm} {mx:.2e}/{rel:.2e}" for nm, mx, rel in errs)
                  + f" (max|err|/max|plain|, ||err||/||plain||); twice: "
                  f"{'bitwise equal' if same else 'DIFFER'}", flush=True)
            if name == "rwkv6-7b/bf16":
                timed[which] = a
            del runs, plain
        if timed:
            order = ("baseline", "new", "new", "baseline") if "baseline" in libs else ("new",)
            times = []
            for which in order:
                build.use("rwkv6_scan", libs[which])
                a = timed[which]
                times.append((f"{which}@{a[-1]}", _ab.cuda_ms(lambda: rwkv6_scan.wkv_bwd(*a))))
            build.use("rwkv6_scan", libs["new"])
            print(f"{name}: K7 ms, in turns: " + ", ".join(f"{w} {ms:.4f}" for w, ms in times),
                  flush=True)
        del r, k, v, w, u, dy, ds, timed
        torch.cuda.empty_cache()
    print(_ab.card())
    print("ALL_OK" if ok_all else "SOME_FAIL")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
