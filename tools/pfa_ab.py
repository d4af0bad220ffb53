#!/usr/bin/env python3
"""Hold the attention kernels (K1 forward, K2 and K3 backwards) of this tree
against their plain versions and, optionally, against another build of the
same CUDA source, on one NVIDIA card.

    python3 tools/pfa_ab.py [--baseline path/to/packed_flash_attention.cu]
                            [--baseline-flags "-DNAME=1 ..."]

Builds ``src/repro_torch/kernels/csrc/packed_flash_attention.cu`` (and prints
the ``-Xptxas -v`` lines of the tensor-core kernels: registers, spills), then
at small edge cases (in bf16 and in fp32) and at the three attention shapes
of the training paths (bf16):

- compares K1's o with ``fwd_plain`` and dq, dk and dv with
  ``bwd_dq_plain`` / ``bwd_dkv_plain`` (relative to each plain output: bf16
  2e-2 max|err|, 1e-2 ||err||; fp32 1e-4, 1e-5), and K1's lse with
  ``fwd_plain``'s (1e-3 absolute in bf16, 1e-4 in fp32, on rows that attend
  anything; exactly -1e30 on rows masked everywhere);
- with ``--baseline``, builds that source with the same flags (and
  ``--baseline-flags``), holds its K1 against ``fwd_plain`` too, requires
  its o, lse, dq, dk and dv to be bitwise equal to this tree's on the same
  inputs (for a change that keeps the kernels' arithmetic), and times K1,
  K2 and K3 at the path shapes in turns: baseline, this tree, this tree,
  baseline (CUDA events, 20 launches each);
- without it, times this tree's K1, K2 and K3 at the path shapes.

A baseline source is typically the parent commit's file, unpacked with
``git archive`` into a directory git ignores; or this tree's own file with
``--baseline-flags=-DPFA_PAD_ALWAYS=1``, which times the kernels a padded
head dim runs (PAD true) against the full-width ones at D 64 and 128.
Exits non-zero on any disagreement.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import shlex
import sys

import _ab


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another packed_flash_attention.cu to compare with")
    ap.add_argument("--baseline-flags", default="",
                    help="extra nvcc flags for the baseline build, e.g. -DPFA_PAD_ALWAYS=1")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("pfa_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import packed_flash_attention as pfa

    def print_ptxas(which, lines):
        """The tensor-core kernels' -Xptxas -v lines (registers, spills) and
        any compiler warning."""
        for i, ln in enumerate(lines):
            if "tc_kernel" in ln and "Compiling entry" in ln:
                print(f"ptxas {which}", ln.strip()[-70:], "|",
                      " | ".join(x.strip() for x in lines[i + 1:i + 3]))
            elif "arning" in ln:
                print(f"ptxas {which}", ln.strip())

    libs, lines = _ab.libraries("packed_flash_attention", args.baseline,
                                shlex.split(args.baseline_flags))
    for which, ls in lines.items():
        print_ptxas(which, ls or ["(library loaded from the build cache)"])

    def use(which):
        build.use("packed_flash_attention", libs[which])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def segments(S, cuts_per_row):
        """Row b holds segments 1, 2, ... between consecutive cuts, 0 after."""
        seg = torch.zeros(len(cuts_per_row), S, dtype=torch.int32)
        for b, cuts in enumerate(cuts_per_row):
            for i in range(len(cuts) - 1):
                seg[b, cuts[i]:cuts[i + 1]] = i + 1
        return seg.to(dev)

    def case(B, KH, G, S, D, causal, window, seg_q, seg_k=None, dtype=torch.bfloat16):
        """K1's and K2/K3's arguments; the backwards take this tree's o, lse."""
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
        q, k, v = rnd(B, KH, G, S, D), rnd(B, KH, S, D), rnd(B, KH, S, D)
        do = rnd(B, KH, G, S, D)
        seg_k = seg_q if seg_k is None else seg_k
        fwd_args = (q, k, v, seg_q, seg_k, causal, window, 64, 64)
        use("new")
        o, lse = pfa.flash_fwd(*fwd_args)
        delta = torch.sum(do.float() * o.float(), -1).contiguous()
        return fwd_args, (q, k, v, seg_q, seg_k, do, lse, delta, causal, window, 64, 64)

    masked = segments(200, [[0, 200]])
    masked[:, :40] = 7                          # 40 query rows attend nothing
    cases = {
        "prime257_D64_causal": (1, 2, 2, 257, 64, True, 0, segments(257, [[0, 257]])),
        "window100_D128": (1, 2, 1, 300, 128, True, 100, segments(300, [[0, 250]])),
        "G4_bidir_D64": (2, 1, 4, 200, 64, False, 0, segments(200, [[0, 150], [0, 60]])),
        "masked_D128": (1, 2, 2, 200, 128, True, 0, masked, segments(200, [[0, 200]])),
        "packed_D64": (2, 2, 2, 300, 64, True, 0,
                       segments(300, [[0, 50, 120, 121, 260, 300], [0, 64, 128, 200, 290, 300]])),
        # the training paths' shapes: InternVL2-2B's encoder and LLM, a Jamba-shaped
        # attention over rows of packed segments
        "encoder": (2, 16, 1, 4096, 64, False, 0, segments(4096, [[0, 3072], [0, 1024]])),
        "llm": (2, 8, 2, 1280, 128, True, 0, segments(1280, [[0, 956], [0, 1280]])),
        "jamba": (2, 8, 4, 4096, 128, True, 0,
                  segments(4096, [[0, 700, 1900, 2000, 3500, 4000], [0, 300, 2600, 4096]])),
    }
    timed = ("encoder", "llm", "jamba")
    # the edge cases again in fp32 (the CUDA-core kernels)
    cases.update({f"{name}_fp32": (*c, *(() if len(c) == 9 else (None,)), torch.float32)
                  for name, c in list(cases.items()) if name not in timed})
    # (max|err| / max|plain|, ||err|| / ||plain||) and lse's absolute bound
    TOL = {torch.bfloat16: (2e-2, 1e-2, 1e-3), torch.float32: (1e-4, 1e-5, 1e-4)}

    def errors(got, ref):
        """(||err|| / ||plain||, max|err| / max|plain|) of each output."""
        rel, mx = [], []
        for g, r in zip(got, ref):
            d, r = g.float() - r.float(), r.float()
            rel.append((d.norm() / r.norm()).item())
            mx.append((d.abs().max() / r.abs().max()).item())
        return rel, mx

    def fmt(xs):
        return "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"

    ok_all = True
    for name, c in cases.items():
        fa, a = case(*c)
        t_max, t_rel, t_lse = TOL[fa[0].dtype]
        o_plain, lse_plain = pfa.fwd_plain(*fa[:-2], 256, 256)
        dead = lse_plain == pfa.NEG_INF
        fwd = {}
        for which in libs:
            use(which)
            o, lse = fwd[which] = pfa.flash_fwd(*fa)
            rel, mx = errors((o,), (o_plain,))
            lse_err = (lse - lse_plain)[~dead].abs().max().item() if (~dead).any() else 0.0
            ok = (rel[0] <= t_rel and mx[0] <= t_max and lse_err <= t_lse
                  and torch.equal(lse[dead], lse_plain[dead])
                  and bool(torch.all(o[dead] == 0)))
            ok_all &= ok
            print(f"{name}: K1 {which} vs plain {'OK' if ok else 'FAIL'} o ||err||/||plain|| "
                  f"{rel[0]:.2e}, max|err|/max|plain| {mx[0]:.2e}; lse max|err| {lse_err:.2e} "
                  f"on live rows, {int(dead.sum())} rows masked everywhere", flush=True)
        if "baseline" in libs:
            same = all(torch.equal(x, y) for x, y in zip(fwd["new"], fwd["baseline"]))
            ok_all &= same
            print(f"{name}: K1 o, lse vs baseline {'bitwise equal' if same else 'DIFFER'}",
                  flush=True)
        outs = {}
        for which in libs:
            use(which)
            outs[which] = (pfa.flash_bwd_dq(*a), *pfa.flash_bwd_dkv(*a))
        plain = (pfa.bwd_dq_plain(*a), *pfa.bwd_dkv_plain(*a))
        torch.cuda.synchronize()
        rel, mx = errors(outs["new"], plain)
        ok = all(x <= t_rel for x in rel) and all(x <= t_max for x in mx)
        same = "baseline" not in libs or all(
            torch.equal(x, y) for x, y in zip(outs["new"], outs["baseline"]))
        ok_all &= ok and same
        print(f"{name}: K2/K3 vs plain {'OK' if ok else 'FAIL'} ||err||/||plain|| {fmt(rel)}, "
              f"max|err|/max|plain| {fmt(mx)}"
              + ("" if "baseline" not in libs else
                 f"; vs baseline {'bitwise equal' if same else 'DIFFER'}"), flush=True)
        if name in timed:
            times = _ab.in_turns("packed_flash_attention", libs, lambda: (
                f"K1 {_ab.cuda_ms(lambda: pfa.flash_fwd(*fa)):.4f} "
                f"K2 {_ab.cuda_ms(lambda: pfa.flash_bwd_dq(*a)):.4f} "
                f"K3 {_ab.cuda_ms(lambda: pfa.flash_bwd_dkv(*a)):.4f} ms"))
            print(f"{name}: " + ", ".join(f"{w}: {t}" for w, t in times), flush=True)
    print(_ab.card())
    print("ALL_OK" if ok_all else "SOME_FAIL")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
