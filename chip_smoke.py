#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   — card name and power limit (``nvidia-smi``); fails without CUDA;
  2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
                with ``nvcc`` and prints the ``-Xptxas -v`` register /
                shared-memory lines;
  3. compare  — K1 forward and K2/K3 gradients (through the autograd
                Function) against the plain PyTorch versions on the card, at
                the main path's two attention shapes (bf16) and at small fp32
                cases (prime length, window, G = 4, rows masked everywhere);
  4. timing   — K1, K2, K3 at the path shapes with CUDA events, beside the
                plain versions, SDPA as a yardstick, and the card's bound;
  5. train    — 3 AdamW steps of InternVL2-2B at full width and depth on the
                paper's mixed data (items that fill the media window; see
                ``rows``); launch counts of K1–K3 over those steps;
  6. paths    — at full width and 2+2 layers, loss and gradients with the
                kernels against the same step through the naive attention
                (the oracle that materializes the scores);
  7. summary  — one JSON line of the kernels, the card line, then the result.

Any failed check raises and the script exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12            # H100 SXM dense tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/packed_flash_attention.cu"
REPLACES = {"K1": "src/repro/kernels/packed_flash_attention.py:59",
            "K2": "src/repro/kernels/packed_flash_attention.py:122",
            "K3": "src/repro/kernels/packed_flash_attention.py:149"}
COUNTER = {"K1": "fwd", "K2": "bwd_dq", "K3": "bwd_dkv"}
# Kernel vs plain, per output, both relative to the plain output itself:
# (max|err| / max|plain|, ||err|| / ||plain||).  In bf16 both sides round
# their fp32 results once (2^-8 relative), so they differ by about one bf16
# ulp where they differ at all; in fp32 only by summation order.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-5)}
# Kernel path vs naive path through the bf16 model, relative.  Measured on
# an H100: loss 1.3e-5, grad norm 3.2e-5, gradients 8.2e-3.
PATH_TOL = {"loss": 2e-4, "grad_norm": 3e-3,
            # ||g_kernel - g_naive|| / ||g_naive|| over every parameter
            "grads": 5e-2}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np

    from repro_torch.common.pytree import global_norm, tree_leaves
    from repro_torch.configs import internvl2_2b
    from repro_torch.data.synthetic import MixedDataset
    from repro_torch.kernels import bench, build
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.models import mllm
    from repro_torch.models.model import FwdCtx
    from repro_torch.train import optim, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device ------------------------------------------------------------ #
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"[device] {name} | count {torch.cuda.device_count()} | nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build ------------------------------------------------------------- #
    t0 = time.perf_counter()
    build.load("packed_flash_attention")
    log(f"[build] {time.perf_counter() - t0:.1f} s "
        f"(nvcc: {json.dumps(build.LOG.seconds)})")
    for lib, lines in build.LOG.ptxas.items():
        for ln in lines:
            log(f"[build] {lib}: {ln.strip()}")

    # 3. kernel vs plain --------------------------------------------------- #
    gen = torch.Generator(device=dev).manual_seed(0)

    def make_case(B, KH, G, S, D, dtype, causal, window, seg_q, seg_k=None):
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dtype)  # noqa: E731
        return dict(q=rnd(B, KH, G, S, D), k=rnd(B, KH, S, D), v=rnd(B, KH, S, D),
                    do=rnd(B, KH, G, S, D), seg_q=seg_q.to(dev, torch.int32),
                    seg_k=(seg_q if seg_k is None else seg_k).to(dev, torch.int32),
                    causal=causal, window=window)

    def run_pair(c):
        """o, dq, dk, dv through the Function, kernels vs plain versions."""
        res = []
        for plain in (False, True):
            q, k, v = (c[n].clone().requires_grad_(True) for n in "qkv")
            o = pfa.packed_flash_attention_bkgsd(
                q, k, v, c["seg_q"], c["seg_k"], causal=c["causal"],
                window=c["window"], block_q=256, block_k=256, plain=plain)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), c["do"])
            res.append((o.detach(), dq, dk, dv))
        torch.cuda.synchronize()
        errs = {}
        for nm, a, b in zip(("o", "dq", "dk", "dv"), *res):
            d, b = a.float() - b.float(), b.float()
            errs[nm] = (d.abs().max().item(), b.abs().max().item(),
                        (d.norm() / b.norm()).item())
        return errs

    def seg_rows(S, lens):
        s = torch.zeros(len(lens), S, dtype=torch.int32)
        for i, n in enumerate(lens):
            s[i, :n] = 1
        return s

    enc, llm_cfg = internvl2_2b.ENCODER, internvl2_2b.LLM
    S_ENC, S_LLM = 4096, 256 + 1024
    path_shapes = {
        # encoder: media mask -> segments {1 real, 0 padded tail}
        "encoder": dict(B=2, KH=enc.n_kv_heads, G=enc.n_heads // enc.n_kv_heads,
                        S=S_ENC, D=enc.head_dim, causal=False,
                        seg=seg_rows(S_ENC, [3072, 1024])),
        # LLM: 256 media tokens (segment 1) + text, segment 0 past text_mask
        "llm": dict(B=2, KH=llm_cfg.n_kv_heads,
                    G=llm_cfg.n_heads // llm_cfg.n_kv_heads, S=S_LLM,
                    D=llm_cfg.head_dim, causal=True,
                    seg=seg_rows(S_LLM, [256 + 700, 256 + 1024])),
    }
    masked = seg_rows(200, [200])
    masked[:, :40] = 7                              # 40 rows attend nothing
    cases = {f"{n}/bf16": make_case(sh["B"], sh["KH"], sh["G"], sh["S"], sh["D"],
                                    torch.bfloat16, sh["causal"], 0, sh["seg"])
             for n, sh in path_shapes.items()}
    cases.update({
        "prime_S257/f32": make_case(1, 2, 2, 257, 64, torch.float32, True, 0,
                                    seg_rows(257, [257])),
        "window100_S300_D128/f32": make_case(1, 2, 1, 300, 128, torch.float32,
                                             True, 100, seg_rows(300, [250])),
        "G4_S200_bidir/f32": make_case(2, 1, 4, 200, 64, torch.float32, False,
                                       0, seg_rows(200, [150, 60])),
        "masked_rows/f32": make_case(1, 2, 2, 200, 64, torch.float32, True, 0,
                                     masked, seg_rows(200, [200])),
    })
    max_err = {}
    for cname, c in cases.items():
        errs = run_pair(c)
        tol_max, tol_rel = TOL[str(c["q"].dtype).split(".")[-1]]
        ok = all(e <= tol_max * m and rel <= tol_rel for e, m, rel in errs.values())
        log(f"[compare] {cname}: " + ", ".join(
            f"{k} max|err| {e:.3e} (tol {tol_max * m:.3e} = {tol_max:.0e} x max|plain| "
            f"{m:.3e}), ||err||/||plain|| {rel:.3e} (tol {tol_rel:.0e})"
            for k, (e, m, rel) in errs.items()) + (" OK" if ok else " FAIL"))
        if not ok:
            raise SystemExit(f"kernel disagrees with plain version: {cname}")
        if cname.endswith("/bf16"):
            shape = cname.split("/")[0]
            max_err[("K1", shape)] = errs["o"][0]
            max_err[("K2", shape)] = errs["dq"][0]
            max_err[("K3", shape)] = max(errs["dk"][0], errs["dv"][0])
    if "masked_rows/f32" in cases:
        c = cases["masked_rows/f32"]
        o, lse = pfa.flash_fwd(c["q"], c["k"], c["v"], c["seg_q"], c["seg_k"],
                               True, 0, 64, 64)
        if not (torch.all(o[..., :40, :] == 0) and torch.all(lse[..., :40] == pfa.NEG_INF)):
            raise SystemExit("rows masked everywhere must give o = 0, lse = -1e30")
    del cases
    torch.cuda.empty_cache()

    # 4. timing ------------------------------------------------------------ #
    def cuda_ms(fn, iters, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    F = torch.nn.functional
    timing = {}
    for shape, sh in path_shapes.items():
        B, KH, G, S, D, causal = (sh[n] for n in ("B", "KH", "G", "S", "D", "causal"))
        H = KH * G
        c = make_case(B, KH, G, S, D, torch.bfloat16, causal, 0, sh["seg"])
        q, k, v, do, seg = c["q"], c["k"], c["v"], c["do"], c["seg_q"]
        o, lse = pfa.flash_fwd(q, k, v, seg, seg, causal, 0, 256, 256)
        delta = torch.sum(do.float() * o.float(), -1).contiguous()
        bargs = (q, k, v, seg, seg, do, lse, delta, causal, 0)
        t = {
            "K1": cuda_ms(lambda: pfa.flash_fwd(q, k, v, seg, seg, causal, 0, 256, 256), 10),
            "K2": cuda_ms(lambda: pfa.flash_bwd_dq(*bargs, 256, 256), 10),
            "K3": cuda_ms(lambda: pfa.flash_bwd_dkv(*bargs, 256, 256), 10),
        }
        plain = {
            "K1": cuda_ms(lambda: pfa.fwd_plain(q, k, v, seg, seg, causal, 0, 256, 256), 3, 1),
            "K2": cuda_ms(lambda: pfa.bwd_dq_plain(*bargs, 256, 256), 3, 1),
            "K3": cuda_ms(lambda: pfa.bwd_dkv_plain(*bargs, 256, 256), 3, 1),
        }
        # the library yardstick: SDPA given the same mask as a boolean tensor
        qs = q.reshape(B, H, S, D)
        keep = seg[:, None, :, None] == seg[:, None, None, :]          # (B,1,S,S)
        if causal:
            keep = keep & torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, k, v, attn_mask=keep, enable_gqa=G > 1)
        lib_fwd = cuda_ms(sdpa, 10)
        lib_err = (sdpa().float() - o.reshape(B, H, S, D).float()).abs().max().item()
        lib_nomask = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, k, v, is_causal=causal, enable_gqa=G > 1), 10)
        qg, kg, vg = (x.clone().requires_grad_(True) for x in (qs, k, v))

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep,
                                               enable_gqa=G > 1)
            torch.autograd.grad(y, (qg, kg, vg), do.reshape(B, H, S, D))
        lib_fwd_bwd = cuda_ms(sdpa_fwd_bwd, 10)

        # operations over the (q, k) pairs this run's mask keeps: 4·D per
        # pair and head forward (QKᵀ and PV), 1.5x that for K2, 2x for K3
        pairs = int(keep.sum())
        f_fwd = 4.0 * D * H * pairs
        e = q.element_size()
        qb, kvb, segb, rowb = q.numel() * e, k.numel() * e, seg.numel() * 4, B * H * S * 4
        work = {   # (operations, bytes: each input read once, each output written once)
            "K1": (f_fwd, qb + 2 * kvb + segb + qb + rowb),
            "K2": (1.5 * f_fwd, qb + 2 * kvb + segb + qb + 2 * rowb + qb),
            "K3": (2.0 * f_fwd, qb + 2 * kvb + segb + qb + 2 * rowb + 2 * kvb),
        }
        for kn, (ops_, nbytes) in work.items():
            t_ops, t_bytes = ops_ / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            timing[(kn, shape)] = dict(
                ms=t[kn], plain_ms=plain[kn], bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib_fwd if kn == "K1" else None)
            r = timing[(kn, shape)]
            log(f"[timing] {kn} {shape} (B={B} KH={KH} G={G} S={S} D={D} bf16 "
                f"causal={causal}): kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{ops_ / r['ms'] / 1e9:.1f} TFLOP/s over the kept pairs")
        timing[("K1", shape)]["library_nomask_ms"] = lib_nomask
        full = bench.attention_flops(B, H, S, D, causal=causal)
        log(f"[timing] {shape}: mask keeps {pairs} (q, k) pairs, "
            f"{4.0 * D * H * pairs / full:.3f} of the dense count; SDPA with the "
            f"mask: fwd {lib_fwd:.3f} ms (max|o - K1| {lib_err:.3e}), fwd+bwd "
            f"{lib_fwd_bwd:.3f} ms; SDPA without it: fwd {lib_nomask:.3f} ms; "
            f"K2+K3 {t['K2'] + t['K3']:.3f} ms")
        del c, q, k, v, do, o, lse, delta, bargs, qs, qg, kg, vg, keep
    torch.cuda.empty_cache()

    # 5. train: InternVL2-2B, full width and depth ------------------------- #
    cfg = internvl2_2b.CFG
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=1024)
    MAX_MEDIA, MAX_TEXT = 4096, 1024

    def rows(n, fill_media):
        """``n`` items of the mix; with ``fill_media`` only items whose media
        fill the 4096-token window.  A zero-padded media tail makes the
        encoder's gradients non-finite at full depth, in the reference as
        in the port (RMSNorm at x = 0 amplifies by eps^-1/2 per norm over 48
        norms); see ROADMAP Queue 3."""
        items = []
        while len(items) < n:
            it = ds.sample(1)[0]
            if not fill_media or it.n_media_items * ds.tokens_per_media_item >= MAX_MEDIA:
                items.append(it)
        return items

    def batch(seed, fill_media=True):
        mbs = [ds.materialize(rows(2, fill_media), embed_dim=cfg.stub.embed_dim,
                              vocab_size=cfg.vocab_size, max_media=MAX_MEDIA,
                              max_text=MAX_TEXT, seed=seed * 10 + i) for i in range(2)]
        return step.as_tensors({k: np.stack([m[k] for m in mbs]) for k in mbs[0]},
                               device=dev)

    t0 = time.perf_counter()
    params = mllm.init(cfg, seed=0, device=dev)
    opt = optim.adamw_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: {n_params / 1e9:.3f} B params (fp32), encoder "
        f"{cfg.encoder.n_layers} x d{cfg.encoder.d_model}, LLM {cfg.llm.n_layers} x "
        f"d{cfg.llm.d_model}; init {time.perf_counter() - t0:.1f} s")
    batches = [batch(s) for s in range(3)]
    train_step = step.make_train_step(cfg, optim.AdamWConfig(), ctx=FwdCtx())
    torch.cuda.reset_peak_memory_stats()
    pfa.reset_launches()
    steps = []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, b, 3e-4)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps.append({"loss": loss, "seconds": dt,
                      "media_tokens": int(b["media_mask"].sum()),
                      "text_tokens": int(b["text_mask"].sum())})
        log(f"[train] step {i}: loss {loss:.5f}, {dt:.3f} s, media tokens "
            f"{steps[-1]['media_tokens']}, text tokens {steps[-1]['text_tokens']} "
            f"(rows: {b['text_mask'].sum(-1).tolist()} text)")
        if not math.isfinite(loss):
            raise SystemExit("non-finite loss")
    # launches per kernel and per path shape, over the 3 steps
    launches = {(kn, shape): pfa.LAUNCHES[(COUNTER[kn], sh["D"], sh["causal"])]
                for shape, sh in path_shapes.items() for kn in COUNTER}
    peak = torch.cuda.max_memory_allocated()
    for shape in path_shapes:
        n = [launches[(kn, shape)] for kn in COUNTER]
        log(f"[train] launches over 3 steps, {shape}: K1 {n[0]}, K2 {n[1]}, K3 {n[2]} "
            f"(per step {n[0] / 3:g}/{n[1] / 3:g}/{n[2] / 3:g})")
    log(f"[train] all launches: {dict(pfa.LAUNCHES)}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    if min(launches.values()) == 0:
        raise SystemExit(f"a kernel was not launched on the main path: {launches}")
    del params, opt, batches, train_step, b
    torch.cuda.empty_cache()

    # 6. kernel path vs naive path (full width, 2 + 2 layers) -------------- #
    cfg2 = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, n_layers=2),
        llm=dataclasses.replace(cfg.llm, n_layers=2))
    params2 = mllm.init(cfg2, seed=1, device=dev)
    # the unfiltered mix: rows with padded media and padded text
    mb = {k: v[0] for k, v in batch(7, fill_media=False).items()}
    log(f"[paths] media per row {mb['media_mask'].sum(-1).tolist()}, "
        f"text per row {mb['text_mask'].sum(-1).tolist()}")
    paths, grads = {}, {}
    for impl in ("kernel", "naive"):
        for p in tree_leaves(params2):
            p.grad = None
        loss = step.make_loss_fn(cfg2, FwdCtx(attn_impl=impl))(params2, mb)
        loss.backward()
        grads[impl] = [p.grad.clone() for p in tree_leaves(params2)]
        gn = global_norm(grads[impl]).item()
        paths[impl] = {"loss": loss.item(), "grad_norm": gn}
        log(f"[paths] attn_impl={impl}: loss {loss.item():.6f}, grad norm {gn:.6f}")
    gap = global_norm([a - b for a, b in zip(grads["kernel"], grads["naive"])]).item()
    rels = {key: abs(paths["kernel"][key] - paths["naive"][key])
            / max(abs(paths["naive"][key]), 1e-12) for key in ("loss", "grad_norm")}
    rels["grads"] = gap / max(paths["naive"]["grad_norm"], 1e-12)
    for key, tol in PATH_TOL.items():
        log(f"[paths] {key}: relative difference {rels[key]:.3e} (tol {tol:.0e})")
        if not (math.isfinite(rels[key]) and rels[key] <= tol):
            raise SystemExit(f"kernel path and naive path disagree on {key}")
    del grads

    # 7. summary ----------------------------------------------------------- #
    kernels = []
    for (kn, shape), r in timing.items():
        kernels.append({
            "name": f"{kn}_{COUNTER[kn]}[{shape}]", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[kn],
            "launches": launches[(kn, shape)], "max_abs_err": max_err[(kn, shape)],
            **r})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
