#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   — card name and power limit (``nvidia-smi``); fails without CUDA;
  2. build    — compiles the three CUDA libraries from
                ``src/repro_torch/kernels/csrc`` side by side (one ``nvcc`` each)
                and prints the ``-Xptxas -v`` register / shared-memory lines;
  3. compare  — each kernel against its plain PyTorch version on the card:
                K1 forward and K2/K3 gradients at the seven attention shapes
                (bf16: InternVL2-2B's encoder and LLM, Jamba's, LLaVA-OV's SigLIP
                at D 72 and Qwen2.5 at G 7, the quickstart's packed 8192-token
                InternLM2-1.8B row of phase 10, a gemma-2b-shaped D 256) and at small
                edge cases in bf16 (K1–K3 on the tensor cores) and in fp32 (K1–K3
                on the CUDA cores) at head dims 24, 32, 64, 72, 80, 128 and 256:
                prime length, a window spanning tiles, G = 4, 7 and 8, rows masked
                everywhere, packed segments; K1 and K2/K3 run twice on each bf16
                case must give bitwise equal o, lse, dq, dk, dv; rows masked
                everywhere give o = 0, lse = -1e30 and dq = 0 exactly; K4–K7 outputs and gradients
                (through their autograd Functions) at RWKV6-7B's and Jamba's
                scan shapes (bf16) and at small cases (prime lengths, several
                chunks, B > 1, S 1 and 5, under a chunk; for K6/K7 S one past
                a chunk, M 32 and a nonzero final-state cotangent, and r, k, v,
                dy one element off 16-byte alignment, K7's plain-load path; for
                K4/K5 di 36, not a multiple of K5's 8 channels a warp, S one past
                K4's tile, and u, dt off 16-byte alignment, their plain-load
                path); the scans' fp32 outputs (K4's h_init, K5's gradients and
                partials, K6's states, K7's gradients, on every scan case)
                against the plain versions' at fp32's tolerance, in bf16 too;
                K4, K5, K6 and K7 run twice on each scan case must give bitwise
                equal outputs; K4's timing line also gives its bound with the
                h_init bytes and its exponential floor;
  4. timing   — every kernel at its path shapes with CUDA events, beside its
                plain version, the card's bound and the PyTorch yardstick
                where one exists (SDPA for K1–K3; none computes a scan);
  5. train    — 3 AdamW steps of InternVL2-2B at full width and depth on the
                paper's mixed data (items that fill the media window; see
                ``mllm_batch``); launch counts of K1–K3 over those steps, by route
                (every K1/K2/K3 launch must take the tensor cores); then one more
                step under ``torch.profiler``: device time per kernel name for
                K1–K3 and the device's idle share over the step;
  6. paths    — at full width and 2+2 layers, loss and gradients with the
                kernels against the same step through the naive attention
                (the oracle that materializes the scores);
  7. llava    — 3 AdamW steps of LLaVA-OV-Qwen2.5-7B: SigLIP-SO400M at its 27
                layers, Qwen2.5-7B at full width cut to 8 layers, on items of 5
                or more images (729 patches each, a 3645-token window); K1–K3 must
                launch on the tensor cores at the SigLIP shape (D 72) and the
                Qwen2.5 shape (D 128, G 7); one more step under ``torch.profiler``
                as in phase 5; then its path check as in phase 6;
  8. decoders — 3 AdamW steps each of RWKV6-7B and Jamba-v0.1 (dense FFNs)
                at full width, depth cut to 8 layers, on rows packed by
                ``pack_items`` from the mixed data; launch counts of K4–K7 and
                of K1–K3 at Jamba's attention shape per step (K1–K3 on the
                tensor cores); one more step of each under ``torch.profiler``:
                K6's and K7's (RWKV6-7B), K4's and K5's (Jamba) device ms in
                the step and the idle share;
  9. ssm paths— at full width and 2 layers, each decoder with the scan
                kernels against the naive scans (Python loops over time);
 10. plan     — the planner (numpy, host seconds): InternVL2-2B's plan theta* on 8
                and 64 H100s, priced by the analytic H100 spec; then the
                quickstart path (``repro_torch.quickstart``): InternLM2-1.8B at full
                width and depth, profiled and planned, the Online Microbatch
                Scheduler feeding packed (4, 1, 8192) rows to 3 AdamW steps (loss,
                seconds, schedule, predicted step, truncation, peak memory; the
                groups must cover each step's items once; K1-K3 launch counts, all
                on the tensor cores), one more step under ``torch.profiler``;
 11. summary  — one JSON line of the kernels, the card line, then the result.

Counts are set to 0 just before a training path and read just after it.
Any failed check raises and the script exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12            # H100 SXM dense tensor-core FLOP/s
# The scans' arithmetic is elementwise fp32 state updates (and exponentials)
# with no matrix product for the tensor cores in their sequential form, so
# their bound takes the fp32 CUDA-core peak.
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12
# The SFUs' exponentials (ex2.approx): 16 a clock an SM, 132 SMs at the H100
# SXM's 1.98 GHz boost clock; K4's floor, printed beside its bound.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
CSRC = "src/repro_torch/kernels/csrc/"
SOURCE = {"K1": "packed_flash_attention.cu", "K2": "packed_flash_attention.cu",
          "K3": "packed_flash_attention.cu", "K4": "mamba_scan.cu",
          "K5": "mamba_scan.cu", "K6": "rwkv6_scan.cu", "K7": "rwkv6_scan.cu"}
REPLACES = {"K1": "src/repro/kernels/packed_flash_attention.py:59",
            "K2": "src/repro/kernels/packed_flash_attention.py:122",
            "K3": "src/repro/kernels/packed_flash_attention.py:149",
            "K4": "src/repro/kernels/mamba_scan.py:41",
            "K5": "src/repro/kernels/mamba_scan.py:68",
            "K6": "src/repro/kernels/rwkv6_scan.py:43",
            "K7": "src/repro/kernels/rwkv6_scan.py:73"}
COUNTER = {"K1": "fwd", "K2": "bwd_dq", "K3": "bwd_dkv"}
# Kernel-name fragments of K1-K3 in a profiler trace (the training paths run
# in bf16: the tensor-core kernels)
TRACE_NAME = {"K1": "fwd_tc_kernel", "K2": "bwd_dq_tc", "K3": "bwd_dkv_tc"}
SCAN_NAME = {"K4": "mamba_fwd", "K5": "mamba_bwd", "K6": "wkv6_fwd",
             "K7": "wkv6_bwd"}
# The bf16 scan kernels in a profiler trace, by name and leading template
# arguments: K4 fwd_kernel<T, N, VEC> and K5 bwd_kernel<T, N, VEC> (mamba_scan.cu,
# N the state width), K6 wkv6_fwd_kernel<T, M, VEC> and K7
# wkv6_bwd_kernel<T, M, VEC> (rwkv6_scan.cu, M the head size); {n} is N or M.
SCAN_TRACE = {"K4": r"\bfwd_kernel<__nv_bfloat16, {n}[,>]",
              "K5": r"\bbwd_kernel<__nv_bfloat16, {n}[,>]",
              "K6": r"\bwkv6_fwd_kernel<__nv_bfloat16, {n}[,>]",
              "K7": r"\bwkv6_bwd_kernel<__nv_bfloat16, {n}[,>]"}
# The decoders' training rows: 2 microbatches x 2 rows x 4096 tokens, items
# of the mixed data packed by pack_items, 256 placeholder tokens per media
# item (InternVL's LLM tokens per image).  Depth cut to 8 layers (one Jamba
# period): RWKV6-7B's 32 layers would need ~121 GB of fp32 parameters and
# AdamW moments, Jamba's experts ~45 GB per MoE layer (ROADMAP Queue 1).
DEC_LAYERS, DEC_S, DEC_MB, DEC_ROWS, DEC_TPM = 8, 4096, 2, 2, 256
# The naive scans' autograd keeps every step's state: the ssm-path check
# runs one microbatch of 2 rows of this length.
PATH_S = 1024
# LLaVA-OV-Qwen2.5-7B's training rows: 729 SigLIP patches per image, a
# 5-image media window (3645 tokens, pooled by 3645 // 196 = 18 to 202 LLM
# tokens, a 9-token tail dropped) and 1024 text tokens.  Qwen2.5 cut from 28
# to 8 layers: fp32 parameters, gradients and AdamW moments take 16 B a
# parameter, 7.615 B parameters at 28 layers would need ~122 GB.
LLAVA_TPM, LLAVA_MEDIA, LLAVA_TEXT, LLAVA_LAYERS = 729, 5 * 729, 1024, 8
# gemma-2b's attention (head_dim 256, MQA over 8 query heads): timed beside
# the paths' shapes; no training path runs it yet.
GEMMA = dict(KH=1, G=8, D=256)
# Kernel vs plain, per output, both relative to the plain output itself:
# (max|err| / max|plain|, ||err|| / ||plain||).  In bf16 both sides round
# their fp32 results once (2^-8 relative), so they differ by about one bf16
# ulp where they differ at all; in fp32 only by summation order.  The scans'
# fp32 outputs (K4's h_init, K5's gradients and partials, K6's states, K7's
# gradients) are held to the fp32 pair in a bf16 case too: both sides compute
# them in fp32 from the same bf16 inputs (1.0e-6 of max apart at Jamba's
# shape, 3.7e-7 at RWKV6-7B's, on an H100).
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-5)}
# Kernel path vs naive path through the bf16 model, relative.  Measured on
# an H100 at 2 layers (loss, grad norm, gradients): InternVL2-2B's attention
# 1.3e-5, 3.2e-5, 8.2e-3; RWKV6-7B's WKV 1.4e-5, 1.3e-4, 1.5e-2; Jamba's
# Mamba + attention 1.4e-5, 5.2e-6, 6.9e-3.  The same bounds hold all three:
# both sides round the fp32 output (and its input gradients) to bf16 once.
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

    from repro_torch import quickstart
    from repro_torch.common.pytree import global_norm, tree_leaves, tree_paths
    from repro_torch.configs import internvl2_2b, jamba_v0_1_52b, llava_ov_qwen7b, rwkv6_7b
    from repro_torch.core.engine import DFLOPEngine
    from repro_torch.core.optimizer.space import ClusterSpec
    from repro_torch.core.profiling.analytic import H100, AnalyticBackend
    from repro_torch.data.packing import pack_items
    from repro_torch.data.synthetic import MixedDataset
    from repro_torch.kernels import bench, build, mamba_scan, rwkv6_scan
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.models import mllm, model
    from repro_torch.models.model import FwdCtx
    from repro_torch.train import optim, step

    t_start = time.perf_counter()

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
    build.load_all(["packed_flash_attention", "mamba_scan", "rwkv6_scan"])
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
        return rel_errors(("o", "dq", "dk", "dv"), *res)

    def rel_errors(names, kernel, plain):
        """Per output: (max|err|, max|plain|, ||err|| / ||plain||); where the
        plain output is all zeros (K5's dA at S 1: h_init = 0) the ratio is
        0 for an all-zero kernel output and inf otherwise."""
        torch.cuda.synchronize()
        errs = {}
        for nm, a, b in zip(names, kernel, plain):
            d, b = a.float() - b.float(), b.float()
            e, n = d.norm().item(), b.norm().item()
            errs[nm] = (d.abs().max().item(), b.abs().max().item(),
                        e / n if n > 0 else (0.0 if e == 0 else math.inf))
        return errs

    def check_pair(cname, errs, dtype):
        """Fail unless every output is within TOL of its plain version."""
        tol_max, tol_rel = TOL[str(dtype).split(".")[-1]]
        ok = all(e <= tol_max * m and rel <= tol_rel for e, m, rel in errs.values())
        log(f"[compare] {cname}: " + ", ".join(
            f"{k} max|err| {e:.3e} (tol {tol_max * m:.3e} = {tol_max:.0e} x max|plain| "
            f"{m:.3e}), ||err||/||plain|| {rel:.3e} (tol {tol_rel:.0e})"
            for k, (e, m, rel) in errs.items()) + (" OK" if ok else " FAIL"))
        if not ok:
            raise SystemExit(f"kernel disagrees with its plain version: {cname}")

    def seg_rows(S, lens):
        s = torch.zeros(len(lens), S, dtype=torch.int32)
        for i, n in enumerate(lens):
            s[i, :n] = 1
        return s

    # the decoders of phases 7-8 and their packed rows (numpy, seeded)
    rwkv_cfg = dataclasses.replace(rwkv6_7b.CFG, n_layers=DEC_LAYERS)
    jamba_cfg = dataclasses.replace(jamba_v0_1_52b.CFG, n_layers=DEC_LAYERS,
                                    ffn_pattern=("dense",))

    def decoder_batch(cfg, seed, n_mb=DEC_MB, S=DEC_S):
        """n_mb x DEC_ROWS rows of S tokens: items of the mixed data drawn
        until a row overflows, then packed (the overflow is truncated and
        counted by pack_items)."""
        ds = MixedDataset("mixed", seed=seed, tokens_per_media_item=DEC_TPM)
        rng = np.random.default_rng(seed)
        packed = []
        for _ in range(n_mb * DEC_ROWS):
            items = ds.sample(1)
            while sum(it.llm_seq_len(DEC_TPM) for it in items) < S:
                items += ds.sample(1)
            packed.append(pack_items(items, S, DEC_TPM, cfg.vocab_size, rng))
        return {k: np.stack([getattr(pb, k)[0] for pb in packed]).reshape(
            n_mb, DEC_ROWS, S) for k in ("tokens", "labels", "segment_ids",
                                         "positions")}

    dec_batches = {"rwkv6-7b": [decoder_batch(rwkv_cfg, s) for s in range(3)],
                   "jamba": [decoder_batch(jamba_cfg, 10 + s) for s in range(3)]}

    # the quickstart path of phase 10 (numpy): its first batch, drawn the same
    # way there; the microbatch with the most segments gives the attention
    # shape of that path timed in phase 4
    qsz = quickstart.CARD

    def quickstart_loader():
        qds = MixedDataset("mixed", seed=0, tokens_per_media_item=qsz.tokens_per_media_item)
        q_eng, q_res, q_prof_s, q_plan_s = quickstart.plan(qsz, qds)
        return quickstart.make_loader(qsz, q_eng, qds), q_res, q_prof_s, q_plan_s

    q_loader = quickstart_loader()[0]
    q_first = next(iter(q_loader))["segment_ids"][:, 0]                   # (N_mb, S)
    q_groups = q_loader.last_schedule.groups
    q_seg = q_first[int(np.argmax([len(np.unique(r)) for r in q_first]))]
    del q_loader
    log(f"[compare] quickstart row (the first batch's microbatch with the most segments): "
        f"tokens by segment id {dict(zip(*(a.tolist() for a in np.unique(q_seg, return_counts=True))))} "
        f"(0 = padding)")

    enc, llm_cfg = internvl2_2b.ENCODER, internvl2_2b.LLM
    S_ENC, S_LLM = 4096, 256 + 1024
    llava_cfg = dataclasses.replace(llava_ov_qwen7b.CFG, llm=dataclasses.replace(
        llava_ov_qwen7b.LLM, n_layers=LLAVA_LAYERS))
    sig, qwen = llava_cfg.encoder, llava_cfg.llm
    LLAVA_POOLED = LLAVA_MEDIA // (LLAVA_MEDIA // llava_cfg.tokens_per_item_out)   # 202
    S_QWEN = LLAVA_POOLED + LLAVA_TEXT
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
        # Jamba's attention layer: packed rows (segments 1..n, 0 = padding)
        "jamba": dict(B=DEC_ROWS, KH=jamba_cfg.n_kv_heads,
                      G=jamba_cfg.n_heads // jamba_cfg.n_kv_heads, S=DEC_S,
                      D=jamba_cfg.head_dim, causal=True,
                      seg=torch.as_tensor(dec_batches["jamba"][0]["segment_ids"][0])),
        # LLaVA-OV's SigLIP (D 72): rows of 5 or more images fill the window
        "siglip": dict(B=2, KH=sig.n_kv_heads, G=sig.n_heads // sig.n_kv_heads,
                       S=LLAVA_MEDIA, D=sig.head_dim, causal=False,
                       seg=seg_rows(LLAVA_MEDIA, [LLAVA_MEDIA, LLAVA_MEDIA])),
        # its Qwen2.5 LLM (D 128, G 7): 202 pooled media tokens + text
        "qwen": dict(B=2, KH=qwen.n_kv_heads, G=qwen.n_heads // qwen.n_kv_heads,
                     S=S_QWEN, D=qwen.head_dim, causal=True,
                     seg=seg_rows(S_QWEN, [LLAVA_POOLED + 700, S_QWEN])),
        # the quickstart's InternLM2-1.8B rows: one packed 8192-token row a
        # microbatch (segments 1..n, 0 = padding)
        "quickstart": dict(B=1, KH=llm_cfg.n_kv_heads,
                           G=llm_cfg.n_heads // llm_cfg.n_kv_heads, S=qsz.token_budget,
                           D=llm_cfg.head_dim, causal=True,
                           seg=torch.as_tensor(q_seg)[None]),
        # gemma-2b-shaped (D 256): timed only
        "gemma": dict(B=2, S=4096, causal=True, seg=seg_rows(4096, [4096, 4096]), **GEMMA),
    }
    masked = seg_rows(200, [200])
    masked[:, :40] = 7                              # 40 rows attend nothing
    # rows of several packed segments (ids 1..5) and a padded tail (0): many
    # 64 x 64 tiles hold no attending pair, so the kernels' segment skip runs
    packed = torch.zeros(2, 300, dtype=torch.int32)
    for row, cuts in enumerate([(0, 50, 120, 121, 260, 300), (0, 64, 128, 200, 290)]):
        for i in range(len(cuts) - 1):
            packed[row, cuts[i]:cuts[i + 1]] = i + 1
    cases = {f"{n}/bf16": make_case(sh["B"], sh["KH"], sh["G"], sh["S"], sh["D"],
                                    torch.bfloat16, sh["causal"], 0, sh["seg"])
             for n, sh in path_shapes.items()}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        cases.update({
            f"prime_S257/{tag}": make_case(1, 2, 2, 257, 64, dt, True, 0,
                                           seg_rows(257, [257])),
            f"window100_S300_D128/{tag}": make_case(1, 2, 1, 300, 128, dt, True, 100,
                                                    seg_rows(300, [250])),
            f"G4_S200_bidir/{tag}": make_case(2, 1, 4, 200, 64, dt, False, 0,
                                              seg_rows(200, [150, 60])),
            f"masked_rows/{tag}": make_case(1, 2, 2, 200, 64, dt, True, 0, masked,
                                            seg_rows(200, [200])),
            f"masked_rows_D128/{tag}": make_case(1, 2, 2, 200, 128, dt, True, 0, masked,
                                                 seg_rows(200, [200])),
            f"packed_segments_D128/{tag}": make_case(2, 2, 2, 300, 128, dt, True, 0, packed),
            # the other head dims of the reference's configs, each in a tile of
            # 64, 128 or 256 columns: the softmax scale must be D^-0.5 of the
            # real D (fp32 at 1e-4 catches the tile width's scale)
            f"prime_S257_D24/{tag}": make_case(1, 2, 2, 257, 24, dt, True, 0,
                                               seg_rows(257, [257])),
            f"G7_S131_D32_bidir/{tag}": make_case(1, 1, 7, 131, 32, dt, False, 0,
                                                  seg_rows(131, [131])),
            f"G7_prime_S257_D72_bidir/{tag}": make_case(1, 2, 7, 257, 72, dt, False, 0,
                                                        seg_rows(257, [200])),
            f"masked_rows_D72/{tag}": make_case(1, 2, 2, 200, 72, dt, True, 0, masked,
                                                seg_rows(200, [200])),
            f"packed_segments_D72/{tag}": make_case(2, 1, 7, 300, 72, dt, True, 0, packed),
            f"prime_S257_D80/{tag}": make_case(1, 2, 2, 257, 80, dt, True, 0,
                                               seg_rows(257, [257])),
            f"packed_segments_D80/{tag}": make_case(2, 2, 2, 300, 80, dt, True, 0, packed),
            f"G7_S131_D128/{tag}": make_case(1, 1, 7, 131, 128, dt, True, 0,
                                             seg_rows(131, [131])),
            f"prime_S257_D256_G8/{tag}": make_case(1, 1, 8, 257, 256, dt, True, 0,
                                                   seg_rows(257, [257])),
            f"masked_rows_D256/{tag}": make_case(1, 1, 2, 200, 256, dt, True, 0, masked,
                                                 seg_rows(200, [200])),
            f"packed_segments_D256/{tag}": make_case(2, 1, 2, 300, 256, dt, False, 0, packed),
        })

    def kernels_twice(c):
        """K1 run twice on the same inputs, then K2 and K3 twice on the first
        run's o and lse: (o, lse, dq, dk, dv) of each run."""
        fwd = [pfa.flash_fwd(c["q"], c["k"], c["v"], c["seg_q"], c["seg_k"],
                             c["causal"], c["window"], 64, 64) for _ in range(2)]
        o, lse = fwd[0]
        delta = torch.sum(c["do"].float() * o.float(), -1).contiguous()
        args = (c["q"], c["k"], c["v"], c["seg_q"], c["seg_k"], c["do"], lse, delta,
                c["causal"], c["window"], 64, 64)
        return [(*fwd[i], pfa.flash_bwd_dq(*args), *pfa.flash_bwd_dkv(*args))
                for i in range(2)]

    max_err = {}
    for cname, c in cases.items():
        errs = run_pair(c)
        check_pair(cname, errs, c["q"].dtype)
        shape = cname.split("/")[0]
        if shape in path_shapes:
            max_err[("K1", shape)] = errs["o"][0]
            max_err[("K2", shape)] = errs["dq"][0]
            max_err[("K3", shape)] = max(errs["dk"][0], errs["dv"][0])
        if c["q"].dtype == torch.bfloat16:
            first, second = kernels_twice(c)
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            log(f"[compare] {cname}: K1 and K2/K3 twice on the same inputs: "
                f"{'bitwise equal' if same else 'DIFFER'}")
            if not same:
                raise SystemExit(f"K1-K3 are not deterministic: {cname}")
    for cname in [n for n in cases if n.startswith("masked_rows")]:
        c = cases[cname]
        o, lse = pfa.flash_fwd(c["q"], c["k"], c["v"], c["seg_q"], c["seg_k"],
                               True, 0, 64, 64)
        if not (torch.all(o[..., :40, :] == 0) and torch.all(lse[..., :40] == pfa.NEG_INF)):
            raise SystemExit(f"rows masked everywhere must give o = 0, lse = -1e30 ({cname})")
        dq = kernels_twice(c)[0][2]
        if not torch.all(dq[..., :40, :] == 0):
            raise SystemExit(f"rows masked everywhere must give dq = 0 ({cname})")
    log("[compare] rows masked everywhere: o = 0, lse = -1e30 and dq = 0 exactly at "
        "D 64, 72, 128 and 256, bf16 and fp32")
    log(f"[compare] launches of the comparisons, by route: {dict(pfa.LAUNCHES)}")
    del cases
    torch.cuda.empty_cache()

    # K4-K7: outputs and gradients through the autograd Functions
    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def rwkv_case(B, H, S, M, dtype, final_cot, path=False, offset=False):
        """r, k, v, w, u and the cotangents of (y, s_final).  At the path
        shape w is the model's decay exp(-exp(dec)), dec in [-6, -1].  With
        ``offset`` the direct K6/K7 calls of ``raw_pair`` take r, k, v, dy
        one element past a 16-byte aligned allocation."""
        r, k, v = (rnd(B, H, S, M, dtype=dtype) for _ in range(3))
        w = (torch.exp(-torch.exp(-6 + 5 * torch.rand(B, H, S, M, generator=gen, device=dev)))
             if path else torch.sigmoid(rnd(B, H, S, M)))
        return dict(kind="rwkv6", ins=(r, k, v, w, rnd(H, M) * 0.1),
                    cots=(rnd(B, H, S, M, dtype=dtype),
                          rnd(B, H, M, M) if final_cot else None),
                    names=("y", "s_final", "dr", "dk", "dv", "dw", "du"), offset=offset)

    def off_view(t):
        """``t``'s values in a contiguous view one element past the start of
        its allocation (not 16-byte aligned)."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        if out.data_ptr() % 16 == 0:
            raise SystemExit("off_view: the view is 16-byte aligned")
        return out

    def mamba_case(B, S, di, N, dtype, path=False, offset=False):
        """u, dt, B_t, C_t, A, D as the model makes them at the path shape
        (dt = softplus(. - 4), A = -(1..N), D = 1) and the cotangent of y.
        With ``offset`` the direct K4/K5 calls of ``raw_pair`` take u and dt
        one element past a 16-byte aligned allocation."""
        u = rnd(B, S, di, dtype=dtype)
        dt = torch.nn.functional.softplus(rnd(B, S, di) - (4 if path else 1)).to(dtype)
        A = (-torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(di, N).contiguous()
             if path else -torch.exp(rnd(di, N) * 0.3))
        D = torch.ones(di, device=dev) if path else rnd(di)
        return dict(kind="mamba", ins=(u, dt, rnd(B, S, N, dtype=dtype),
                                       rnd(B, S, N, dtype=dtype), A, D),
                    cots=(rnd(B, S, di, dtype=dtype),),
                    names=("y", "du", "ddt", "dB", "dC", "dA", "dD"), offset=offset)

    def scan_pair(c):
        """Outputs and input gradients, kernels vs plain versions."""
        res = []
        for plain in (False, True):
            ts = [t.clone().requires_grad_(True) for t in c["ins"]]
            if c["kind"] == "rwkv6":
                outs = rwkv6_scan.rwkv6_scan_bhsm(*ts, plain=plain)
            else:
                outs = (mamba_scan.mamba_scan_bsd(*ts, plain=plain),)
            live = [(o, g) for o, g in zip(outs, c["cots"]) if g is not None]
            grads = torch.autograd.grad([o for o, _ in live], ts,
                                        [g for _, g in live])
            res.append([o.detach() for o in outs] + list(grads))
        return rel_errors(c["names"], *res)

    SCAN_SHAPES = {"rwkv6-7b": dict(B=DEC_ROWS, H=rwkv_cfg.d_model // rwkv_cfg.rwkv_head_dim,
                                    S=DEC_S, M=rwkv_cfg.rwkv_head_dim),
                   "jamba": dict(B=DEC_ROWS, S=DEC_S, di=jamba_cfg.ssm_expand * jamba_cfg.d_model,
                                 N=jamba_cfg.ssm_d_state)}
    sh_r, sh_m = SCAN_SHAPES["rwkv6-7b"], SCAN_SHAPES["jamba"]
    scan_cases = {
        # training passes no final-state cotangent
        "rwkv6-7b/bf16": lambda: rwkv_case(sh_r["B"], sh_r["H"], sh_r["S"], sh_r["M"],
                                           torch.bfloat16, False, path=True),
        "jamba/bf16": lambda: mamba_case(sh_m["B"], sh_m["S"], sh_m["di"], sh_m["N"],
                                         torch.bfloat16, path=True),
        "rwkv6_prime_S257_B2_ds/f32": lambda: rwkv_case(2, 3, 257, 64, torch.float32, True),
        "rwkv6_S97_M32_ds/f32": lambda: rwkv_case(1, 2, 97, 32, torch.float32, True),
        "rwkv6_S1_ds/f32": lambda: rwkv_case(1, 2, 1, 64, torch.float32, True),
        "rwkv6_S5_B3/f32": lambda: rwkv_case(3, 2, 5, 64, torch.float32, False),
        f"rwkv6_S{rwkv6_scan.CHUNK + 1}_ds/f32": lambda: rwkv_case(
            1, 3, rwkv6_scan.CHUNK + 1, 64, torch.float32, True),
        "rwkv6_S33_B3_M32_ds/f32": lambda: rwkv_case(3, 2, 33, 32, torch.float32, True),
        "rwkv6_S61_offset_ds/f32": lambda: rwkv_case(2, 2, 61, 64, torch.float32, True,
                                                     offset=True),
        "rwkv6_S5_B3/bf16": lambda: rwkv_case(3, 2, 5, 64, torch.bfloat16, False),
        "rwkv6_S61_offset_ds/bf16": lambda: rwkv_case(2, 2, 61, 64, torch.bfloat16, True,
                                                      offset=True),
        "mamba_prime_S257_di300/f32": lambda: mamba_case(2, 257, 300, 16, torch.float32),
        "mamba_S97_B3_di130/f32": lambda: mamba_case(3, 97, 130, 16, torch.float32),
        "mamba_S1_di36/f32": lambda: mamba_case(1, 1, 36, 16, torch.float32),
        "mamba_S5_B3_di36/f32": lambda: mamba_case(3, 5, 36, 16, torch.float32),
        "mamba_S5_B3_di36/bf16": lambda: mamba_case(3, 5, 36, 16, torch.bfloat16),
        # one step past K4's tile, and u, dt off 16-byte alignment (K4's and
        # K5's plain-load path)
        f"mamba_S{mamba_scan.K4_TILE + 1}_B2/bf16": lambda: mamba_case(
            2, mamba_scan.K4_TILE + 1, 256, 16, torch.bfloat16),
        "mamba_S61_offset/bf16": lambda: mamba_case(2, 61, 384, 16, torch.bfloat16,
                                                    offset=True),
        "mamba_S61_offset/f32": lambda: mamba_case(2, 61, 384, 16, torch.float32,
                                                   offset=True),
    }
    log(f"[compare] scan chunks: K4/K5 {mamba_scan.CHUNK}, K6/K7 {rwkv6_scan.CHUNK}")

    def raw_pair(c):
        """The scans' fp32 outputs, kernel vs plain version on the same
        inputs, whatever the case's type (both sides compute in fp32, so
        they are held to fp32's TOL; the autograd outputs above are rounded
        to the inputs' type), and the kernels that must give bitwise equal
        outputs when run twice on the same inputs, each with whether they
        did.  The plain versions take the sequences padded to a chunk
        multiple with identity steps.  Mamba: K4 twice (y, h_init), then
        K5 twice on its h_init; with ``offset`` the kernels take u and dt as
        unaligned views.  RWKV6: K6 twice (y, s_final, s_init), then K7
        twice on its states, with the case's final-state cotangent (zeros,
        as training runs it, where it has none); with ``offset`` the kernels
        take r, k, v, dy as unaligned views."""
        if c["kind"] == "rwkv6":
            r, k, v, w, uu = c["ins"]
            B, H, S, M = r.shape
            dy = c["cots"][0]
            ds = c["cots"][1] if c["cots"][1] is not None else torch.zeros((B, H, M, M),
                                                                          device=dev)
            chunk = min(rwkv6_scan.CHUNK, S)
            S_p = -(-S // chunk) * chunk
            pad = lambda t, x=0.0: torch.nn.functional.pad(t, (0, 0, 0, S_p - S), value=x)  # noqa: E731
            kr, kk, kv, kdy = ((off_view(t) for t in (r, k, v, dy)) if c["offset"]
                               else (r, k, v, dy))
            fwd_runs = [rwkv6_scan.wkv_fwd(kr, kk, kv, w, uu, chunk) for _ in range(2)]
            _, s_fin, s_init = fwd_runs[0]
            runs = [rwkv6_scan.wkv_bwd(kr, kk, kv, w, uu, s_init, kdy, ds, chunk)
                    for _ in range(2)]
            _, p_fin, p_init = rwkv6_scan.fwd_plain(pad(r), pad(k), pad(v), pad(w, 1.0), uu,
                                                    chunk)
            ref = rwkv6_scan.bwd_plain(pad(r), pad(k), pad(v), pad(w, 1.0), uu, s_init,
                                       pad(dy), ds, chunk)
            ref = [x[:, :, :S] for x in ref[:4]] + [ref[4]]
            return (rel_errors(("s_final", "s_init", "dr", "dk", "dv", "dw", "du"),
                               (s_fin, s_init, *runs[0]), (p_fin, p_init, *ref)),
                    {"K6": all(torch.equal(a, b) for a, b in zip(*fwd_runs)),
                     "K7": all(torch.equal(a, b) for a, b in zip(*runs))})
        u, dtt, Bt, Ct, A, D = c["ins"]
        dy = c["cots"][0]
        S = u.shape[1]
        chunk = min(mamba_scan.CHUNK, S)
        S_p = -(-S // chunk) * chunk
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, S_p - S))  # noqa: E731
        ku, kdt = (off_view(u), off_view(dtt)) if c["offset"] else (u, dtt)
        fwd_runs = [mamba_scan.scan_fwd(ku, kdt, Bt, Ct, A, D, chunk) for _ in range(2)]
        _, h_init = fwd_runs[0]
        _, p_init = mamba_scan.fwd_plain(pad(u), pad(dtt), pad(Bt), pad(Ct), A, D, chunk)
        runs = [mamba_scan.scan_bwd(ku, kdt, Bt, Ct, A, D, h_init, dy, chunk)
                for _ in range(2)]
        ref = mamba_scan.bwd_plain(pad(u), pad(dtt), pad(Bt), pad(Ct), A, D, h_init,
                                   pad(dy), chunk)
        ref = [x[:, :S] for x in ref[:2]] + [x[:, :, :S] for x in ref[2:4]] + list(ref[4:])
        return (rel_errors(("h_init", "du", "ddt", "dB", "dC", "dA", "dD"),
                           (h_init, *runs[0]), (p_init, *ref)),
                {"K4": all(torch.equal(a, b) for a, b in zip(*fwd_runs)),
                 "K5": all(torch.equal(a, b) for a, b in zip(*runs))})

    for cname, make in scan_cases.items():
        c = make()
        errs = scan_pair(c)
        check_pair(cname, errs, c["ins"][0].dtype)
        fwd, bwd = ("K6", "K7") if c["kind"] == "rwkv6" else ("K4", "K5")
        raw, same = raw_pair(c)
        check_pair(f"{cname} {fwd}/{bwd} fp32 outputs", raw, torch.float32)
        for kn, eq in same.items():
            log(f"[compare] {cname}: {kn} twice on the same inputs: "
                f"{'bitwise equal' if eq else 'DIFFER'}")
            if not eq:
                raise SystemExit(f"{kn} is not deterministic: {cname}")
        if cname.endswith("/bf16") and cname.split("/")[0] in SCAN_SHAPES:
            shape = cname.split("/")[0]
            n_out = 2 if c["kind"] == "rwkv6" else 1
            max_err[(fwd, shape)] = max(e for e, _, _ in list(errs.values())[:n_out])
            max_err[(bwd, shape)] = max(e for e, _, _ in list(errs.values())[n_out:])
        del c
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
        # SDPA's backward alone: fwd+bwd - fwd, one number for K2 and K3 together
        lib = {"K1": lib_fwd, "K2": lib_fwd_bwd - lib_fwd, "K3": lib_fwd_bwd - lib_fwd}
        for kn, (ops_, nbytes) in work.items():
            t_ops, t_bytes = ops_ / PEAK_BF16 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            timing[(kn, shape)] = dict(
                ms=t[kn], plain_ms=plain[kn], bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib[kn],
                library_note=("SDPA with the same boolean mask" if kn == "K1" else
                              "SDPA backward (fwd+bwd - fwd), dq and dk/dv together"))
            r = timing[(kn, shape)]
            log(f"[timing] {kn} {shape} (B={B} KH={KH} G={G} S={S} D={D} bf16 "
                f"causal={causal}, {pfa.route_of(q.dtype)}): kernel "
                f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % of it), "
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

    # K4-K7 at the decoders' scan shapes (bf16 sequences, f32 decay / A, D)
    c = scan_cases["rwkv6-7b/bf16"]()
    r, k, v, w, u = c["ins"]
    dy = c["cots"][0]
    ds = torch.zeros(sh_r["B"], sh_r["H"], sh_r["M"], sh_r["M"], device=dev)
    y, s_fin, s_init = rwkv6_scan.wkv_fwd(r, k, v, w, u, rwkv6_scan.CHUNK)
    y_p, _, s_init_p = rwkv6_scan.fwd_plain(r, k, v, w, u, rwkv6_scan.CHUNK)
    scan_t = {
        "K6": (cuda_ms(lambda: rwkv6_scan.wkv_fwd(r, k, v, w, u, rwkv6_scan.CHUNK), 10),
               cuda_ms(lambda: rwkv6_scan.fwd_plain(r, k, v, w, u, rwkv6_scan.CHUNK), 1, 0)),
        "K7": (cuda_ms(lambda: rwkv6_scan.wkv_bwd(r, k, v, w, u, s_init, dy, ds,
                                                  rwkv6_scan.CHUNK), 10),
               cuda_ms(lambda: rwkv6_scan.bwd_plain(r, k, v, w, u, s_init_p, dy, ds,
                                                    rwkv6_scan.CHUNK), 1, 0)),
    }
    del c, r, k, v, w, u, dy, ds, y, s_fin, s_init, y_p, s_init_p
    c = scan_cases["jamba/bf16"]()
    u, dtt, Bt, Ct, A, D = c["ins"]
    dy = c["cots"][0]
    y, h_init = mamba_scan.scan_fwd(u, dtt, Bt, Ct, A, D, mamba_scan.CHUNK)
    scan_t["K4"] = (cuda_ms(lambda: mamba_scan.scan_fwd(u, dtt, Bt, Ct, A, D,
                                                        mamba_scan.CHUNK), 10),
                    cuda_ms(lambda: mamba_scan.fwd_plain(u, dtt, Bt, Ct, A, D,
                                                         mamba_scan.CHUNK), 1, 0))
    scan_t["K5"] = (cuda_ms(lambda: mamba_scan.scan_bwd(u, dtt, Bt, Ct, A, D, h_init, dy,
                                                        mamba_scan.CHUNK), 10),
                    cuda_ms(lambda: mamba_scan.bwd_plain(u, dtt, Bt, Ct, A, D, h_init, dy,
                                                         mamba_scan.CHUNK), 1, 0))
    del c, u, dtt, Bt, Ct, A, D, dy, y, h_init
    torch.cuda.empty_cache()
    # (shape, operations, bytes).  K6/K7: the operations the WKV recurrence
    # needs (5 and 11 per state element and step); K4/K5: the reference's
    # selective-scan count, the backward at 2x (both are bound by bytes).
    dims_r = [sh_r[n] for n in "BHSM"]
    work = {
        "K6": ("rwkv6-7b", bench.rwkv6_fwd_ops(*dims_r), bench.rwkv6_fwd_bytes(*dims_r, 2)),
        "K7": ("rwkv6-7b", bench.rwkv6_bwd_ops(*dims_r), bench.rwkv6_bwd_bytes(*dims_r, 2)),
        "K4": ("jamba", bench.mamba_flops(sh_m["B"], sh_m["S"], sh_m["di"], sh_m["N"]),
               bench.mamba_fwd_bytes(sh_m["B"], sh_m["S"], sh_m["di"], sh_m["N"], 2)),
        "K5": ("jamba", 2 * bench.mamba_flops(sh_m["B"], sh_m["S"], sh_m["di"], sh_m["N"]),
               bench.mamba_bwd_bytes(sh_m["B"], sh_m["S"], sh_m["di"], sh_m["N"], 2)),
    }
    for kn, (shape, ops_, nbytes) in work.items():
        t_ops, t_bytes = ops_ / PEAK_FP32 * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        ms_k, ms_p = scan_t[kn]
        timing[(kn, shape)] = dict(
            ms=ms_k, plain_ms=ms_p, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None,
            library_note="none: no PyTorch call computes a "
                         + ("WKV6 recurrence" if kn in ("K6", "K7") else "selective scan"))
        log(f"[timing] {kn} {shape} ({json.dumps(SCAN_SHAPES[shape])} bf16): kernel "
            f"{ms_k:.3f} ms, plain {ms_p:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: {ops_ / 1e9:.2f} GFLOP at "
            f"67 TFLOP/s fp32 = {t_ops:.4f} ms, {nbytes / 1e9:.3f} GB = {t_bytes:.4f} ms), "
            f"{ops_ / ms_k / 1e9:.2f} TFLOP/s")
    log(f"[timing] the reference's WKV count (bench.rwkv6_flops, 6 per state element "
        f"and step) would be {bench.rwkv6_flops(*dims_r) / 1e9:.2f} GFLOP for K6")
    # K4's other floors, logged only: its bytes with the chunk-initial states it
    # writes for K5, and its exponentials (one a state element and step) on the
    # SFUs at the H100's rated clock
    dims_m = [sh_m[n] for n in ("B", "S", "di", "N")]
    hi_bytes = bench.mamba_fwd_h_init_bytes(*dims_m, mamba_scan.CHUNK)
    t_hi = (work["K4"][2] + hi_bytes) / HBM_BYTES_PER_S * 1e3
    n_exp = bench.mamba_fwd_exps(*dims_m)
    t_exp = n_exp / SFU_EXP_PER_S * 1e3
    log(f"[timing] K4 jamba: with h_init at chunk {mamba_scan.CHUNK} "
        f"({hi_bytes / 1e9:.3f} GB more) its bytes take {t_hi:.4f} ms; its "
        f"{n_exp / 1e9:.3f} G exponentials at 16 a clock an SM (132 SMs, 1.98 GHz) "
        f"{t_exp:.4f} ms, {100 * t_exp / scan_t['K4'][0]:.1f} % of the kernel's "
        f"{scan_t['K4'][0]:.3f} ms")

    # Launches at the gemma-shaped key (bf16, D 256, causal), summed over every
    # training phase's 3 steps: each phase adds its counts before the next resets
    # them.  No path trains head dim 256, so the sum reads 0 unless one does.
    gemma_launches = {kn: 0 for kn in COUNTER}

    def count_gemma():
        for kn in COUNTER:
            gemma_launches[kn] += pfa.LAUNCHES[(COUNTER[kn], pfa.route_of(torch.bfloat16),
                                                GEMMA["D"], path_shapes["gemma"]["causal"])]

    def check_routes(tag):
        """Fail unless every K1/K2/K3 launch since the last reset took the
        tensor cores (the training paths run in bf16)."""
        off = {key: n for key, n in pfa.LAUNCHES.items() if key[1] != pfa.TENSOR_CORE}
        if off:
            raise SystemExit(f"{tag}: K1-K3 launches off the tensor cores: {off}")
        log(f"[{tag}] every K1/K2/K3 launch took the tensor cores")

    def profile_step(fn, tag, shapes, step_s, scans=()):
        """Run ``fn`` (one train step) under torch.profiler and print the
        device time per kernel name for K1-K3 at each of ``shapes`` that has
        attention and for the bf16 scan kernels ``scans`` at ``shapes[0]``
        (beside the isolated time, phase 4), the ten kernels with the most
        device time, and
        the device's idle share: over the traced step (whose host side the
        profiler slows) and against ``step_s``, the untraced step's seconds.
        A trace with no device events prints "not measured"."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("train_step"):
                fn()
                torch.cuda.synchronize()
        events = list(prof.events())
        window = [e for e in events if e.name == "train_step"]
        # device activity: kernels, copies, sets; not the annotation's own
        # device-side span, which covers the whole window
        dev_events = [e for e in events
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and e.name != "train_step"]
        if not window or not dev_events:
            log(f"[profile] {tag}: device time per kernel and idle share: not measured "
                f"(the trace holds {len(dev_events)} device events)")
            return
        t0, t1 = window[0].time_range.start, window[0].time_range.end
        per_name = {}
        spans = []
        for e in dev_events:
            a, b = max(e.time_range.start, t0), min(e.time_range.end, t1)
            if b <= a:
                continue
            spans.append((a, b))
            tot, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (tot + (e.time_range.end - e.time_range.start), n + 1)
        busy, end = 0.0, t0                 # union of the device intervals
        for a, b in sorted(spans):
            if b > end:
                busy += b - max(a, end)
                end = b
        span_us = t1 - t0
        log(f"[profile] {tag}: one traced step {span_us / 1e3:.1f} ms, device busy "
            f"{busy / 1e3:.1f} ms, idle share {1 - busy / span_us:.3f}; against the "
            f"untraced step of {step_s * 1e3:.1f} ms, idle share "
            f"{1 - busy / 1e6 / step_s:.3f}; {sum(n for _, n in per_name.values())} "
            f"device events, {len(per_name)} kernel names")
        for kn, frag in TRACE_NAME.items():
            for shape in (sh for sh in shapes if sh in path_shapes):   # attention shapes
                # the instantiation: tile width, and whether the head dim pads it
                D = path_shapes[shape]["D"]
                tile = next(w for w in (64, 128, 256) if D <= w)
                inst = f"<{tile}, {'true' if D < tile else 'false'}>"
                hits = [(nm, tot, n) for nm, (tot, n) in per_name.items()
                        if frag in nm and inst in nm]
                tot = sum(t for _, t, _ in hits)
                n = sum(c for _, _, c in hits)
                iso = timing[(kn, shape)]["ms"]
                if n:
                    log(f"[profile] {tag} {kn} {shape}: {tot / 1e3:.3f} ms device time over "
                        f"{n} launches in the step, {tot / 1e3 / n:.3f} ms per launch "
                        f"(isolated {iso:.3f} ms); {[nm[:60] for nm, _, _ in hits]}")
                else:
                    log(f"[profile] {tag} {kn} {shape}: no launch found in the trace")
        for kn in scans:
            sh = SCAN_SHAPES[shapes[0]]
            pat = re.compile(SCAN_TRACE[kn].format(n=sh["N"] if "N" in sh else sh["M"]))
            hits = [(nm, tot, n) for nm, (tot, n) in per_name.items() if pat.search(nm)]
            tot, n = sum(t for _, t, _ in hits), sum(c for _, _, c in hits)
            iso = timing[(kn, shapes[0])]["ms"]
            log(f"[profile] {tag} {kn}: {tot / 1e3:.3f} ms device time a step over {n} "
                f"launches, {tot / 1e3 / max(n, 1):.3f} ms per launch (isolated {iso:.3f} "
                f"ms); {[nm[:70] for nm, _, _ in hits]}")
        top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
        for nm, (tot, n) in top:
            log(f"[profile] {tag} top: {tot / 1e3:9.3f} ms {n:5d} x {nm[:110]}")

    # 5. train: InternVL2-2B, full width and depth ------------------------- #
    def mllm_batch(ds, cfg, max_media, max_text, seed, fill_media=True):
        """2 microbatches x 2 rows of the mix; with ``fill_media`` only items
        whose media fill the ``max_media``-token window.  A zero-padded media
        tail makes the encoder's gradients non-finite at full depth, in the
        reference as in the port (RMSNorm at x = 0 amplifies by eps^-1/2 per
        norm over 48 norms); see ROADMAP Queue 3."""
        mbs = []
        for i in range(2):
            items = []
            while len(items) < 2:
                it = ds.sample(1)[0]
                if not fill_media or it.n_media_items * ds.tokens_per_media_item >= max_media:
                    items.append(it)
            mbs.append(ds.materialize(items, embed_dim=cfg.stub.embed_dim,
                                      vocab_size=cfg.llm.vocab_size, max_media=max_media,
                                      max_text=max_text, seed=seed * 10 + i))
        return step.as_tensors({k: np.stack([m[k] for m in mbs]) for k in mbs[0]},
                               device=dev)

    def train_mllm(tag, cfg, batches, shapes):
        """3 AdamW steps of ``cfg`` on ``batches``; fails on a non-finite loss,
        unless K1, K2 and K3 each launched at every one of ``shapes`` (by
        head_dim and causality), or if any launch left the tensor cores.
        Returns (params, opt, steps, launches by (kernel, shape))."""
        t0 = time.perf_counter()
        params = mllm.init(cfg, seed=0, device=dev)
        opt = optim.adamw_init(params)
        n_params = sum(p.numel() for p in tree_leaves(params))
        torch.cuda.synchronize()
        log(f"[train] {cfg.name}: {n_params / 1e9:.3f} B params (fp32), encoder "
            f"{cfg.encoder.n_layers} x d{cfg.encoder.d_model} (head_dim "
            f"{cfg.encoder.head_dim}), LLM {cfg.llm.n_layers} x d{cfg.llm.d_model} "
            f"(head_dim {cfg.llm.head_dim}, G {cfg.llm.n_heads // cfg.llm.n_kv_heads}); "
            f"init {time.perf_counter() - t0:.1f} s")
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
            log(f"[train] {tag} step {i}: loss {loss:.5f}, {dt:.3f} s, media tokens "
                f"{steps[-1]['media_tokens']}, text tokens {steps[-1]['text_tokens']} "
                f"(rows: {b['text_mask'].sum(-1).tolist()} text)")
            if not math.isfinite(loss):
                raise SystemExit(f"{tag}: non-finite loss")
        count_gemma()
        # launches per kernel and per path shape, over the 3 steps, on the route
        # each kernel must take in bf16 (the tensor cores)
        counts = {(kn, shape): pfa.LAUNCHES[(COUNTER[kn], pfa.route_of(torch.bfloat16),
                                             path_shapes[shape]["D"],
                                             path_shapes[shape]["causal"])]
                  for shape in shapes for kn in COUNTER}
        peak = torch.cuda.max_memory_allocated()
        for shape in shapes:
            n = [counts[(kn, shape)] for kn in COUNTER]
            log(f"[train] {tag} launches over 3 steps, {shape} (D {path_shapes[shape]['D']}, "
                f"causal {path_shapes[shape]['causal']}): K1 {n[0]}, K2 {n[1]}, K3 {n[2]} "
                f"(per step {n[0] / 3:g}/{n[1] / 3:g}/{n[2] / 3:g})")
        log(f"[train] {tag} all launches (kernel, route, head_dim, causal): "
            f"{dict(pfa.LAUNCHES)}; max_memory_allocated {peak / 2**30:.2f} GiB")
        if min(counts.values()) == 0:
            raise SystemExit(f"{tag}: a kernel was not launched on the main path: {counts}")
        check_routes(tag)
        if peak >= 80e9:
            raise SystemExit(f"{tag}: peak {peak / 1e9:.1f} GB is not under 80 GB")
        return params, opt, steps, counts

    cfg = internvl2_2b.CFG
    ds = MixedDataset("mixed", seed=0, tokens_per_media_item=1024)
    MAX_MEDIA, MAX_TEXT = 4096, 1024
    batches = [mllm_batch(ds, cfg, MAX_MEDIA, MAX_TEXT, s) for s in range(3)]
    mllm_shapes = ("encoder", "llm")
    params, opt, steps, launches = train_mllm("InternVL2-2B", cfg, batches, mllm_shapes)
    train_step = step.make_train_step(cfg, optim.AdamWConfig(), ctx=FwdCtx())

    # one more step under the profiler: device time per kernel name, idle share
    profile_step(lambda: train_step(params, opt, batches[0], 3e-4), "InternVL2-2B",
                 mllm_shapes, sum(st["seconds"] for st in steps[1:]) / len(steps[1:]))
    del params, opt, batches, train_step
    torch.cuda.empty_cache()

    # 6. kernel path vs naive path (full width, 2 + 2 layers) -------------- #
    def path_gap(tag, loss_for, params, mb):
        """Loss and gradients of one microbatch through the kernel path and
        the naive path (``loss_for(impl)`` builds each loss function); fails
        past PATH_TOL.  Prints the leaves that carry most of the gap."""
        named = tree_paths(params)
        paths, grads = {}, {}
        for impl in ("kernel", "naive"):
            for _, p in named:
                p.grad = None
            t0 = time.perf_counter()
            loss = loss_for(impl)(params, mb)
            loss.backward()
            grads[impl] = [p.grad.clone() for _, p in named]
            gn = global_norm(grads[impl]).item()
            paths[impl] = {"loss": loss.item(), "grad_norm": gn}
            log(f"[{tag}] {impl}: loss {loss.item():.6f}, grad norm {gn:.6f} "
                f"({time.perf_counter() - t0:.1f} s)")
        gaps = [(a - b).norm().item() for a, b in zip(grads["kernel"], grads["naive"])]
        gap = math.sqrt(sum(g * g for g in gaps))
        top = sorted(range(len(gaps)), key=lambda i: -gaps[i])[:6]
        log(f"[{tag}] largest shares of ||g_kernel - g_naive||^2: " + ", ".join(
            f"{named[i][0]} {gaps[i] ** 2 / max(gap, 1e-30) ** 2:.3f} (leaf "
            f"{gaps[i] / max(grads['naive'][i].norm().item(), 1e-30):.2e})" for i in top))
        rels = {key: abs(paths["kernel"][key] - paths["naive"][key])
                / max(abs(paths["naive"][key]), 1e-12) for key in ("loss", "grad_norm")}
        rels["grads"] = gap / max(paths["naive"]["grad_norm"], 1e-12)
        for key, tol in PATH_TOL.items():
            log(f"[{tag}] {key}: relative difference {rels[key]:.3e} (tol {tol:.0e})")
            if not (math.isfinite(rels[key]) and rels[key] <= tol):
                raise SystemExit(f"{tag}: kernel path and naive path disagree on {key}")

    def mllm_path_gap(tag, cfg, mb):
        """``cfg`` at 2 + 2 layers, kernel path vs naive path on ``mb``."""
        cfg2 = dataclasses.replace(
            cfg, encoder=dataclasses.replace(cfg.encoder, n_layers=2),
            llm=dataclasses.replace(cfg.llm, n_layers=2))
        params2 = mllm.init(cfg2, seed=1, device=dev)
        log(f"[{tag}] media per row {mb['media_mask'].sum(-1).tolist()}, "
            f"text per row {mb['text_mask'].sum(-1).tolist()}")
        path_gap(f"{tag} attn_impl",
                 lambda impl: step.make_loss_fn(cfg2, FwdCtx(attn_impl=impl)), params2, mb)
        del params2
        torch.cuda.empty_cache()

    # the unfiltered mix: rows with padded media and padded text
    mllm_path_gap("paths", cfg, {k: v[0] for k, v in mllm_batch(
        ds, cfg, MAX_MEDIA, MAX_TEXT, 7, fill_media=False).items()})

    # 7. train: LLaVA-OV-Qwen2.5-7B, SigLIP at 27 layers, Qwen2.5 at 8 ---- #
    lds = MixedDataset("mixed", seed=0, tokens_per_media_item=LLAVA_TPM)
    llava_shapes = ("siglip", "qwen")
    batches = [mllm_batch(lds, llava_cfg, LLAVA_MEDIA, LLAVA_TEXT, s) for s in range(3)]
    log(f"[train] LLaVA-OV: Qwen2.5 cut from {llava_ov_qwen7b.LLM.n_layers} to "
        f"{llava_cfg.llm.n_layers} layers; {LLAVA_MEDIA} media tokens a row pooled to "
        f"{LLAVA_POOLED}, {LLAVA_TEXT} text tokens")
    params, opt, steps, counts = train_mllm("LLaVA-OV-Qwen2.5-7B", llava_cfg, batches,
                                            llava_shapes)
    launches.update(counts)
    train_step = step.make_train_step(llava_cfg, optim.AdamWConfig(), ctx=FwdCtx())
    profile_step(lambda: train_step(params, opt, batches[0], 3e-4), "LLaVA-OV-Qwen2.5-7B",
                 llava_shapes, sum(st["seconds"] for st in steps[1:]) / len(steps[1:]))
    del params, opt, batches, train_step
    torch.cuda.empty_cache()
    mllm_path_gap("llava paths", llava_cfg, {k: v[0] for k, v in mllm_batch(
        lds, llava_cfg, LLAVA_MEDIA, LLAVA_TEXT, 7, fill_media=False).items()})

    # 8. train: RWKV6-7B and Jamba, full width, 8 layers ------------------ #
    def reset_counts():
        for mod in (pfa, mamba_scan, rwkv6_scan):
            mod.reset_launches()

    def train_decoder(name, cfg, full, profile=False):
        """3 AdamW steps of ``cfg``; with ``profile``, one more step under
        torch.profiler after the counts are read (phase 8)."""
        t0 = time.perf_counter()
        params = model.init(cfg, seed=0, device=dev)
        opt = optim.adamw_init(params)
        n_params = sum(p.numel() for p in tree_leaves(params))
        torch.cuda.synchronize()
        kinds = [k.value for k in cfg.layer_kinds]
        log(f"[decoders] {name}: {n_params / 1e9:.3f} B params (fp32), {cfg.n_layers} "
            f"layers of d{cfg.d_model} ({', '.join(kinds)}), FFN pattern {cfg.ffn_pattern}; "
            f"cut from {full.n_layers} layers and FFN pattern {full.ffn_pattern}; "
            f"{DEC_MB} x {DEC_ROWS} rows x {DEC_S} tokens; init {time.perf_counter() - t0:.1f} s")
        batches = [step.as_tensors(b, device=dev) for b in dec_batches[name]]
        train_step = step.make_train_step(cfg, optim.AdamWConfig(), ctx=FwdCtx())
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        seconds = []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            params, opt, m = train_step(params, opt, b, 3e-4)
            loss = m["loss"].item()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            used = (b["segment_ids"] > 0).sum(-1).tolist()
            log(f"[decoders] {name} step {i}: loss {loss:.5f}, "
                f"{seconds[-1]:.3f} s, tokens in segments per row {used}")
            if not math.isfinite(loss):
                raise SystemExit(f"{name}: non-finite loss")
        count_gemma()
        counts = {("K4", name): mamba_scan.LAUNCHES["fwd"],
                  ("K5", name): mamba_scan.LAUNCHES["bwd"],
                  ("K6", name): rwkv6_scan.LAUNCHES["fwd"],
                  ("K7", name): rwkv6_scan.LAUNCHES["bwd"]}
        for kn in COUNTER:
            counts[(kn, name)] = sum(n for (kk, route, _, _), n in pfa.LAUNCHES.items()
                                     if kk == COUNTER[kn]
                                     and route == pfa.route_of(torch.bfloat16))
        check_routes(f"decoders {name}")
        log(f"[decoders] {name}: launches over 3 steps " + ", ".join(
            f"{kn} {n} ({n / 3:g}/step)" for (kn, _), n in counts.items()) +
            f"; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if profile:
            profile_step(lambda: train_step(params, opt, batches[0], 3e-4), name, (name,),
                         sum(seconds[1:]) / len(seconds[1:]),
                         scans=("K6", "K7") if name == "rwkv6-7b" else ("K4", "K5"))
        del params, opt, batches, train_step
        torch.cuda.empty_cache()
        return counts

    dec_counts = {**train_decoder("rwkv6-7b", rwkv_cfg, rwkv6_7b.CFG, profile=True),
                  **train_decoder("jamba", jamba_cfg, jamba_v0_1_52b.CFG, profile=True)}
    on_path = [("K6", "rwkv6-7b"), ("K7", "rwkv6-7b"), ("K4", "jamba"), ("K5", "jamba"),
               ("K1", "jamba"), ("K2", "jamba"), ("K3", "jamba")]
    if any(dec_counts[key] == 0 for key in on_path):
        raise SystemExit(f"a kernel was not launched on a decoder path: {dec_counts}")
    launches.update({key: dec_counts[key] for key in on_path})

    # 9. scan kernels vs naive scans (full width, 2 layers) ---------------- #
    for dec, cfg2 in (("rwkv6-7b", dataclasses.replace(rwkv_cfg, n_layers=2)),
                      ("jamba", dataclasses.replace(jamba_cfg, n_layers=2,
                                                    layer_pattern=("mamba", "attention")))):
        params2 = model.init(cfg2, seed=1, device=dev)
        mb = {k: v[0] for k, v in step.as_tensors(
            decoder_batch(cfg2, 20, n_mb=1, S=PATH_S), device=dev).items()}
        log(f"[ssm paths] {dec}: {[k.value for k in cfg2.layer_kinds]}, "
            f"{DEC_ROWS} rows x {PATH_S} tokens")
        path_gap(f"ssm paths {dec} ssm_impl",
                 lambda impl: step.make_loss_fn(cfg2, FwdCtx(ssm_impl=impl)), params2, mb)
        del params2, mb
        torch.cuda.empty_cache()

    # 10. plan: the planner, then the quickstart's scheduled steps -------- #
    # (a) InternVL2-2B's plan (encoder + LLM) on 8 and 64 H100s, numpy on the
    # host, priced by the analytic H100 spec
    for n_cards in (8, 64):
        cluster = ClusterSpec(n_chips=n_cards, chips_per_node=8, mem_bytes=H100.mem_bytes,
                              name="h100-sxm")
        p_eng = DFLOPEngine(llm_cfg=internvl2_2b.LLM, enc_cfg=internvl2_2b.ENCODER,
                            e_seq_len=internvl2_2b.PATCHES_PER_IMAGE, cluster=cluster,
                            tokens_per_media_item=internvl2_2b.LLM_TOKENS_PER_IMAGE,
                            backend=AnalyticBackend(H100))
        t0 = time.perf_counter()
        p_eng.profile(MixedDataset("mixed", seed=0,
                                   tokens_per_media_item=internvl2_2b.LLM_TOKENS_PER_IMAGE),
                      n_samples=2048)
        t1 = time.perf_counter()
        res = p_eng.plan(gbs=64)
        t2 = time.perf_counter()
        if not (res.found and math.isfinite(res.makespan)):
            raise SystemExit(f"plan: no feasible plan for InternVL2-2B on {n_cards} cards")
        log(f"[plan] InternVL2-2B on {n_cards} x {cluster.name} (gbs 64): theta* "
            f"{res.plan.as_tuple()}, predicted makespan {res.makespan:.6f} s, "
            f"{res.n_configs} configurations searched ({res.n_feasible} feasible); host: "
            f"profile {t1 - t0:.3f} s, plan {t2 - t1:.3f} s")

    # (b) quickstart: InternLM2-1.8B at full width and depth, its engine's plan,
    # the Online Microbatch Scheduler feeding packed (N_mb, 1, 8192) rows to
    # make_train_step; three steps counted, a fourth under the profiler
    loader, res, prof_s, plan_s = quickstart_loader()
    log(f"[plan] {qsz.cfg.name} (LLM only) on {quickstart.CLUSTER.n_chips} x "
        f"{quickstart.CLUSTER.name} (gbs {quickstart.PLAN_GBS}): theta* "
        f"{res.plan.as_tuple()}, predicted makespan {res.makespan:.6f} s, "
        f"{res.n_configs} configurations searched; host: profile {prof_s:.3f} s, plan "
        f"{plan_s:.3f} s; runs {quickstart.LOCAL_PLAN.as_tuple()} on this card, "
        f"{qsz.gbs} items a step into rows of {qsz.token_budget} tokens")
    reset_counts()
    steps_q = quickstart.train(qsz, loader, steps=4, device=dev, lr=qsz.lr)
    q_seconds = []
    for i in range(3):
        params, r = next(steps_q)
        sc = r["schedule"]
        covered = sorted(j for g in sc.groups for j in g)
        # the items' predicted durations summed: the price of running the
        # microbatches in turn on one card (step_makespan prices every
        # microbatch at the slowest one, cmax)
        serial = float(sc.e_dur.sum() + sc.l_dur.sum())
        log(f"[plan] step {i}: loss {r['loss']:.5f}, {r['seconds']:.3f} s (loader "
            f"{r['load_seconds']:.3f} s), schedule: solver {sc.solver}, groups "
            f"{[len(g) for g in sc.groups]}, imbalance {sc.imbalance:.4f}, cmax "
            f"{sc.cmax:.4f} s, predicted step {sc.step_makespan:.4f} s (measured / "
            f"predicted {r['seconds'] / sc.step_makespan:.3f}), items' predicted sum "
            f"{serial:.4f} s (measured / sum {r['seconds'] / serial:.3f}), tokens in "
            f"segments per row {r['row_tokens']} of {qsz.token_budget}, truncated "
            f"{r['truncated']} tokens, peak {r['peak_gib']:.2f} GiB")
        if i == 0:
            log(f"[plan] step 0's groups are those of the batch whose segments phase 4 "
                f"timed: {sc.groups == q_groups}")
        if not math.isfinite(r["loss"]):
            raise SystemExit("plan: non-finite loss")
        if covered != list(range(qsz.gbs)):
            raise SystemExit(f"plan: step {i}'s groups do not cover its items once: "
                             f"{sc.groups}")
        q_seconds.append(r["seconds"])
    count_gemma()
    n_q = {kn: pfa.LAUNCHES[(COUNTER[kn], pfa.route_of(torch.bfloat16), llm_cfg.head_dim,
                             True)] for kn in COUNTER}
    log(f"[plan] launches over 3 steps (D {llm_cfg.head_dim}, causal, S "
        f"{qsz.token_budget}), by route: {dict(pfa.LAUNCHES)}; K1 {n_q['K1']}, K2 "
        f"{n_q['K2']}, K3 {n_q['K3']} (per step {n_q['K1'] / 3:g}/{n_q['K2'] / 3:g}/"
        f"{n_q['K3'] / 3:g})")
    if min(n_q.values()) == 0:
        raise SystemExit(f"plan: a kernel was not launched on the quickstart path: {n_q}")
    check_routes("plan")
    launches.update({(kn, "quickstart"): n for kn, n in n_q.items()})
    profile_step(lambda: next(steps_q), qsz.cfg.name, ("quickstart",),
                 sum(q_seconds[1:]) / len(q_seconds[1:]))
    del params, steps_q, loader
    torch.cuda.empty_cache()
    # the gemma-shaped attention is timed (phase 4); these are its launches on
    # the five training paths
    launches.update({(kn, "gemma"): n for kn, n in gemma_launches.items()})
    log(f"[train] gemma-shaped (bf16, D {GEMMA['D']}, causal) launches over every training "
        f"phase: {gemma_launches}")

    # 11. summary ---------------------------------------------------------- #
    kernels = []
    for (kn, shape), r in timing.items():
        kernels.append({
            "name": f"{kn}_{SCAN_NAME.get(kn) or COUNTER[kn]}[{shape}]", "route": "cuda",
            "source": CSRC + SOURCE[kn], "replaces": REPLACES[kn],
            "launches": launches[(kn, shape)], "max_abs_err": max_err[(kn, shape)],
            # the gemma-shaped rows are timed and compared, but no path trains them
            "on_path": shape != "gemma", **r})
    log(f"[summary] wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
