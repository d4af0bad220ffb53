#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device   — card name and power limit (``nvidia-smi``); fails without CUDA;
  2. build    — compiles the three CUDA libraries from
                ``src/repro_torch/kernels/csrc`` side by side (one ``nvcc`` each)
                and prints the ``-Xptxas -v`` register / shared-memory lines;
  3. compare  — each kernel against its plain PyTorch version on the card:
                K1 forward and K2/K3 gradients at the twelve attention shapes
                of the training paths (bf16: InternVL2-2B's encoder and LLM,
                Jamba's, LLaVA-OV's SigLIP at D 72 and Qwen2.5 at G 7, the
                quickstart's packed 8192-token InternLM2-1.8B row of phase 10,
                phase 12's Granite-MoE at G 3, Mixtral's 4096 window over 8192-token
                rows, HuBERT's bidirectional D 80 and gemma-2b's MQA at D 256; in
                fp32 the 100M MLLM's encoder and LLM of phase 11) and at small
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
                h_init bytes and its exponential floor; then K4/K5 with segment
                restart words (``phase_restarts``: Jamba2-3B's shape and edge
                cases against the plain versions, timed with and without);
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
  8. decoders — 3 AdamW steps each of RWKV6-7B and Jamba-v0.1 (dense FFNs;
                its Mamba layers restarting at each packed segment, so every
                K4/K5 launch must carry restart words)
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
 11. runtime  — the closed control loop (``repro_torch.runtime``) on the reference's
                100M MLLM: ``bench_kernel`` times K1-K3 (fp32, at the quickstart's
                InternLM2-1.8B attention) and K4-K7 (fp32, the reference's bench dims) over
                S 1024-8192 through the kernels' entry points, ``normalize`` gives each
                kernel's measured / analytic-H100 unit, ``seed_calibrator`` feeds a fresh
                ``OnlineCalibrator``; then ``python -m repro_torch.train_mllm`` at
                mllm-100m, full size (fp32: K1-K3 on the CUDA cores, all must): 24 steps
                over a single-image -> video shift at step 6 with background re-planning, a
                trace and a checkpoint (a shape-ks drift event and a finished re-plan
                required; the trace must hold schedule, step, replan-search and drift
                events; the checkpoint must restore bitwise), 12 steps with the lookahead
                composer, 12 steps of random assignment; per step loss, seconds beside the
                predicted cmax and step, whether a re-plan search was in flight; drift
                events, re-plans, metrics, launches, peak; each adopted re-plan is a
                physical swap of (params, opt) through ``launch.reshard.ParamSwapper``
                (physical swaps, reshard_mean_s, the trace's reshard spans: one a swap,
                and the state bitwise unchanged by each); one more step of each under
                ``torch.profiler``;
 12. archs    — the registry's configurations (``configs.get_config``) through
                ``make_train_step(ModelConfig)``, 3 AdamW steps each, K1-K3 launches
                by route (all on the tensor cores), peak memory, then one more step
                under ``torch.profiler`` (K1-K3 device ms, the expert GEMMs, the MoE
                dispatch and the LM head by group, idle share): (a) Granite-MoE-3B-A800M
                at full size (40 experts top-8, capacity path at factor 2.0) on packed
                rows, with each step's moe_drop_rate and moe_imbalance; (b) Mixtral-8x7B
                at full width cut to 2 layers, on 8192-token rows; (c) one MoE layer of
                each at full width, the capacity path (nothing dropped) against the
                dense oracle (loss, output, gradients of x, router and experts), and
                twice, bitwise; (d) HuBERT-XLarge at full size, the encoder-only
                masked-prediction loss on seeded frame embeddings; (e) gemma-2b at
                full size;
 13. serve    — the serving path (``repro_torch.serve``, ``phase_serve``): Qwen2.5-7B
                at full size (bf16 weights), a batch of prompts of different lengths
                prefilled through K1 and held against teacher-forced decode through
                the KV cache, then 8 rows decoding greedy at per-row positions with a
                row parked and merged back (tokens unchanged); Jamba and RWKV6-7B at
                full width, 8 layers, prefilled through K4 (and K1) and K6 and held
                against decode through their Mamba and RWKV6 caches, in bf16 and
                again in fp32 (``SERVE_TOL``, ``SERVE_TOL_F32``); InternLM2-1.8B at
                full size (fp32) through ``DFLOPEngine.serving(backend="real")`` on a
                single-image -> video stream under "slo" and "fifo" (every request
                completes; sampled requests' tokens equal their solo greedy runs);
                K1, K4 and K6 at the serve shapes against their plain versions, timed
                beside their bounds (and SDPA for K1);
 14. dist     — the distributed core (``launch``, ``sharding``, ``core.communicator``,
                ``core.pipeline.executor``, ``phase_dist``) under NCCL at a world of 1
                (the card is one rank): InternLM2-1.8B's 24 layers at full width,
                stacked and run through ``pipeline_forward`` (one stage, 4
                microbatches of the quickstart's packed 8192-token rows), forward and
                backward against the sequential loop over the same layers (output,
                loss and gradients within PATH_TOL; whether bitwise equal), K1-K3
                launches by route; InternVL2-2B's step through
                ``make_train_step(communicator=make_communicator(...))`` held to the
                same loss and gradients without the hook; ``explicit_gather_scatter``
                on the card; the vocab-parallel CE's ``None`` at model size 1;
                InternVL2-2B's parameter and optimizer-state specs on the 1x1 mesh
                and a stand-in 16x16;
 15. elastic  — the physical reshard (``launch.reshard``, ``phase_elastic``) under NCCL
                at a world of 1: InternLM2-1.8B's 24 layers stacked (fp32) with two AdamW
                moments, 18.1 GB of state, through ``ParamSwapper`` over PP 1 -> 4 -> 2 ->
                8 -> 3 -> 6 -> 1 on ``clamped_plan_mesh``: each swap's seconds, GB/s and
                peak above what was allocated before it, ``estimate_cost_s`` before and
                after the first swap; after each, ``pipeline_forward`` over the placed
                layers on the quickstart's first batch (K1 on the tensor cores), bitwise
                equal to the output before the chain.  Kill and revive (N -> N-1 -> N)
                need a rank a host and run on gloo ranks on the CPU only;
 16. shard    — the sharded layer paths (``phase_shard``, ``shard_rank``) on 16 gloo
                ranks that share the card (NCCL refuses two ranks on one device; each
                rank a process of its own on a ``FileStore``, its tensors on the card,
                gloo staging each collective through host memory), a (1, 16) ("data",
                "model") mesh: one MoE layer each of Jamba-v0.1 (16 experts: the EP
                path, one a rank), Granite-MoE-3B-A800M and Mixtral-8x7B (40 and 8:
                the TP-expert path) at full width in bf16, 4096 tokens, capacity factor
                E / k, against the whole layer's capacity path and dense oracle on
                rank 0 (y within TOL, loss and the gradients of x, the router and every
                rank's expert slices within PATH_TOL; path, seconds and peak a rank;
                two sharded runs bitwise equal, reported only); Jamba's Mamba scan at
                full width (di 8192, 512 channels a rank), B 2 x S 4096 in fp32,
                through ``ssm_scan_sharded`` against the unsharded naive scan (y and h
                2e-5, the six gradients 2e-4); Mixtral-8x7B at full width, 2 layers,
                under ``FwdCtx(shard_ctx, moe_impl="ep")`` on a (1, 4) mesh of ranks
                0-3 (2 experts a rank) against rank 0's single-process step (loss and
                gradients within PATH_TOL), K1-K3 launches a rank (all on the tensor
                cores).  No collective here is timed across cards;
 17. drivers  — ``python -m repro_torch.plan_inspector`` (the default llava-ov-qwen7b on
                256 H100s), ``serve_decode`` and ``serve_mllm`` on the card: exit 0
                and the reference's lines (theta* and baselines; ``generated`` for each
                tiny family; the three parts, the real backend ``completed n/n``);
 18. dryrun   — the dry run (``repro_torch.launch.dryrun``, ``phase_dryrun``): (a)
                gemma-2b's step as phase 12(e) runs it (full size, fp32 parameters,
                ``FwdCtx()``, 2 x 2 rows of 2048 tokens) once for real on the card under
                the ``hlo_stats`` recorder and once on fake CUDA tensors on a 1x1 mesh of
                a fake process group: the dry run's argument bytes against the live
                bytes of the parameters, moments and batch, and its FLOPs against the
                real step's, each within 1 %; its predicted peak printed beside
                ``max_memory_allocated``; (b) ``python -m repro_torch.launch.dryrun``
                as subprocesses, side by side, on the production meshes
                (``DRYRUN_COMBOS``, as many as fit the phase's budget): each must
                exit 0; peak GB a rank, ``fits_80gb``, FLOPs a rank and collective bytes
                by kind printed from its record;
 19. summary  — one JSON line of the kernels, the card line, then the result.

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
# The fp32 (CUDA-core) K1-K3 in a profiler trace, by name and tile width {t}
# (fwd_kernel<D>; K4's fwd_kernel<T, N, VEC> does not match)
FP32_TRACE = {"K1": r"\bfwd_kernel<{t}>", "K2": r"\bbwd_dq_kernel<{t}>",
              "K3": r"\bbwd_dkv_kernel<{t}[,>]"}
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
# Phase 12's paths (``configs.get_config``): Granite-MoE-3B-A800M at full
# size on the decoders' 2 x 2 rows of 4096 packed tokens; Mixtral-8x7B at
# full width cut from 32 to 2 layers (16 B a parameter of fp32 state: 3.165 B
# parameters at 2 layers take 50.6 GB) on 2 x 1 rows of 8192, so its 4096
# window masks whole key tiles; HuBERT-XLarge at full size on 2 x 2 rows of
# 4096 seeded frame embeddings; gemma-2b at full size on 2 x 2 rows of 2048
# (its fp32 logits at vocab 256000 take 1 GB a 1024 tokens).
MIXTRAL_LAYERS, MIXTRAL_S, GEMMA_S = 2, 8192, 2048
# MoE dispatch ops in a profiler trace (phase 12's device ms by group),
# forward and backward
DISPATCH_OPS = {"aten::topk", "aten::cumsum", "aten::bincount", "aten::gather",
                "aten::index_add", "aten::index_add_", "aten::index_select"}
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
# Phase 13's serving paths.  Every prompt token of a cache-filling prefill
# is one eager decode step (the reference's teacher-forced design; 44 ms a
# token for Qwen2.5-7B on an H100, host-bound), so the prompts are short.
# Qwen2.5-7B at full size with bf16 weights (7.6 B parameters, 15.2 GB): 4
# prompts right-padded to 128 tokens through K1, then 8 rows of 8-32 prompt
# tokens decoding SERVE_STEPS greedy steps in a cache of SERVE_CTX tokens a
# row (0.94 GB of bf16 KV).  Jamba and RWKV6-7B at the decoders' width and
# depth (8 layers), 2 prompts.
SERVE_QWEN_LENS, SERVE_SSM_LENS = (128, 96, 48, 17), (128, 75)
SERVE_ROWS, SERVE_STEPS, SERVE_CTX = 8, 34, 2048
SERVE_PARK_ROW, SERVE_PARK_AT, SERVE_PARK_STEPS = 3, 16, 2
# InternLM2-1.8B behind DFLOPEngine.serving(backend="real"): 8 LLM tokens
# per media item, so prompts of 12-80 tokens, max_len 256
SERVE_TPM, SERVE_REQS, SERVE_MAX_LEN, SERVE_NEW, SERVE_SAMPLED = 8, 16, 256, 16, 4
# The kernel prefill (the whole prompt at once) against teacher-forced
# decode through the caches, per row's last-token logits, relative to the
# decode's: (max|err| / max|decode|, ||err|| / ||decode||).  In bf16 both
# round each product and layer output to bf16, at other batch shapes and in
# another order (Mamba's decode step runs in fp32 past its fp32 conv window,
# as the reference's does), and random weights amplify it: ||err|| /
# ||decode|| measured 1.9e-2 to 2.1e-2 on Qwen2.5-7B, 2.8e-2 to 3.0e-2 on
# Jamba and 8.7e-2 to 8.8e-2 on RWKV6-7B (H100, 700 W).  The same check
# in fp32 (Jamba and RWKV6-7B, K1/K4/K6 on their fp32 routes), where only
# summation order separates the paths, holds them to SERVE_TOL_F32; a wrong
# position, mask or carried state is off by O(1) in either.
SERVE_TOL, SERVE_TOL_F32 = (2e-1, 2e-1), (1e-3, 1e-3)


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def rel_errors(names, kernel, plain):
    """Per output: (max|err|, max|plain|, ||err|| / ||plain||); where the
    plain output is all zeros (K5's dA at S 1: h_init = 0) the ratio is
    0 for an all-zero kernel output and inf otherwise."""
    import torch
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


def cuda_ms(fn, iters, warmup=2):
    """Milliseconds a call of ``fn`` over ``iters`` calls, by CUDA events."""
    import torch
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


# K4/K5 with segment restarts (phase 3): the tolerances of their fp32 sums
# and of K4's y written in bf16
RESTART_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 4e-3)}
# Jamba2-3B's scan (jamba2-3b.mixed: B 1, S 8192, d_inner 5120): a packed
# row of the mixed traffic (items of 2,104, 3,400 and 2,600 tokens, then
# padding); restarts at step 1, at a K5 group's and a K4 tile's first step
# and inside them, at the last step; a restart on every step
JAMBA2_SCAN = dict(S=8192, di=5120)
JAMBA2_ROWS = ([2104, 5504, 8104], [1, 16, 17, 64, 100, 4096, 4097, 8191],
               list(range(1, 8192)))


def phase_restarts(dev):
    """Phase 3, K4 and K5 with segment restarts (the words the main path's
    Mamba layers pass where a configuration restarts at each packed
    segment): each against its plain version (``fwd_plain`` /
    ``bwd_plain`` with the same words) at RESTART_TOL, twice for bitwise
    equality, and all-zero words bitwise equal to none; K5 is fed this
    build's K4 states.  Cases: Jamba2-3B's shape (``JAMBA2_ROWS``, bf16) and
    edge cases (restarts at a group's and a tile's first step and inside
    them, at step 1 and the last step, on every step; chunks 1, 3, 16 and
    40; S 1 and 97; B 3; d_inner 36 and 300; fp32 and bf16).  Then K4 and
    K5 timed at Jamba2-3B's shape on its packed row, without and with the
    words, in turns.  Runs alone too: ``python3 -c 'import chip_smoke, torch;
    chip_smoke.phase_restarts(torch.device("cuda"))'``."""
    if os.path.join(HERE, "src") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    from repro_torch.kernels import mamba_scan
    from repro_torch.kernels.blocking import MAMBA_PAD_DT, pad_axis

    def case(B, S, di, dtype, starts_at, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        r = lambda *s: torch.randn(*s, generator=g, device=dev)   # noqa: E731
        u, Bt, Ct, dy = (r(B, S, n).to(dtype) for n in (di, 16, 16, di))
        dt = torch.nn.functional.softplus(r(B, S, di) - 3.0).to(dtype)
        A = -torch.exp(torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
                       .expand(di, 16) + 0.1 * r(di, 16)).contiguous()
        mask = torch.zeros((B, S), dtype=torch.bool, device=dev)
        for b, ts in enumerate(starts_at):
            mask[b, [t for t in ts if 0 < t < S]] = True
        return (u, dt, Bt, Ct, A, r(di), dy), mamba_scan.start_words(mask)

    def within(errs, dtype):
        tol_max, tol_rel = RESTART_TOL[dtype]
        return all(e <= tol_max * m and rel <= tol_rel for e, m, rel in errs.values())

    def fmt(errs):
        return ", ".join(f"{k} {e / max(m, 1e-30):.2e}/{rel:.2e}"
                         for k, (e, m, rel) in errs.items())

    def check(name, ins, words, chunk):
        u, dt, Bt, Ct, A, D, dy = ins
        S = u.shape[1]
        c = min(chunk, S)
        pad = lambda t, v=0.0: pad_axis(t, -(-S // c) * c, axis=1, value=v)   # noqa: E731
        y_p, i_p = mamba_scan.fwd_plain(pad(u), pad(dt, MAMBA_PAD_DT), pad(Bt), pad(Ct), A, D,
                                        c, words)
        runs = [mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c, words) for _ in range(2)]
        zero = torch.zeros_like(words)
        errs_y = rel_errors(("y",), runs[0][:1], (y_p[:, :S],))
        errs_h = rel_errors(("h_init",), runs[0][1:], (i_p,))
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        none = all(torch.equal(a, b) for a, b in zip(
            mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c, zero),
            mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c)))
        ok = within(errs_y, str(u.dtype).split(".")[-1]) and within(errs_h, "float32") \
            and same and none
        line = (f"[compare] restarts {name}: K4 chunk {c} {fmt({**errs_y, **errs_h})}; "
                f"twice {'bitwise' if same else 'DIFFER'}; zero words = none: "
                f"{'bitwise' if none else 'DIFFER'}")
        if c <= mamba_scan.K5_CHUNK:
            h_init = runs[0][1]
            p = mamba_scan.bwd_plain(pad(u), pad(dt, MAMBA_PAD_DT), pad(Bt), pad(Ct), A, D,
                                     h_init, pad(dy), c, words)
            p = [x[:, :S] for x in p[:2]] + [x[:, :, :S] for x in p[2:4]] + list(p[4:])
            k5 = [mamba_scan.scan_bwd(u, dt, Bt, Ct, A, D, h_init, dy, c, words)
                  for _ in range(2)]
            errs5 = rel_errors(("du", "ddt", "dB", "dC", "dA", "dD"), k5[0], p)
            same5 = all(torch.equal(a, b) for a, b in zip(*k5))
            none5 = all(torch.equal(a, b) for a, b in zip(
                mamba_scan.scan_bwd(u, dt, Bt, Ct, A, D, h_init, dy, c, zero),
                mamba_scan.scan_bwd(u, dt, Bt, Ct, A, D, h_init, dy, c)))
            ok = ok and within(errs5, "float32") and same5 and none5
            line += (f" | K5 {fmt(errs5)}; twice {'bitwise' if same5 else 'DIFFER'}; "
                     f"zero words = none: {'bitwise' if none5 else 'DIFFER'}")
        log(line + (" OK" if ok else " FAIL"))
        if not ok:
            raise SystemExit(f"K4/K5 with restarts disagree with their plain versions: {name}")

    S, di = JAMBA2_SCAN["S"], JAMBA2_SCAN["di"]
    cases = {"jamba2-3b/bf16": ((len(JAMBA2_ROWS), S, di, torch.bfloat16, JAMBA2_ROWS),
                                mamba_scan.CHUNK)}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        cases.update({
            f"edges_S97_B3_di300/{tag}": ((3, 97, 300, dtype, [[1, 16, 17, 32, 64, 96],
                                                               [15, 31, 63, 65],
                                                               list(range(1, 97))]), 16),
            f"S97_chunk3/{tag}": ((2, 97, 256, dtype, [[3, 4, 50, 64, 90], [2]]), 3),
            f"S129_chunk1/{tag}": ((1, 129, 128, dtype, [[1, 63, 64, 65, 128]]), 1),
            f"S1_di36/{tag}": ((1, 1, 36, dtype, [[]]), 16),
            f"S200_chunk40/{tag}": ((2, 200, 128, dtype, [[40, 41, 120], [199]]), 40),
        })
    for name, ((B, S_, di_, dtype, starts), chunk) in cases.items():
        ins, words = case(B, S_, di_, dtype, starts)
        check(name, ins, words, chunk)
        del ins, words
        torch.cuda.empty_cache()
    # timing on the packed row
    ins, words = case(1, S, di, torch.bfloat16, JAMBA2_ROWS[:1])
    u, dt, Bt, Ct, A, D, dy = ins
    c = mamba_scan.CHUNK
    _, h_init = mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c)
    turns = []
    for w in (None, words, None, words):
        turns.append((w is not None,
                      cuda_ms(lambda: mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, c, w), 20),
                      cuda_ms(lambda: mamba_scan.scan_bwd(u, dt, Bt, Ct, A, D, h_init, dy, c,
                                                          w), 20)))
    log("[timing] jamba2-3b scan (B 1, S 8192, d_inner 5120, bf16), ms a launch (K4, K5), "
        "in turns: " + ", ".join(f"{'with' if r else 'without'} restarts {a:.4f} {b:.4f}"
                                 for r, a, b in turns))
    del ins, words, u, dt, Bt, Ct, A, D, dy, h_init
    torch.cuda.empty_cache()


def phase_serve(dev, timing, launches, max_err):
    """Phase 13: the serving path (``repro_torch.serve``) on the card.

    (a) Qwen2.5-7B at full size, bf16 weights: ``make_prefill_step`` over a
    batch of prompts of different lengths (K1; last-token logits at each
    row's own length) held against ``prefill_into_cache`` (teacher-forced
    decode through the KV cache) at SERVE_TOL; then 8 rows handed off into
    one decode batch (``merge_cache_row``) and decoded SERVE_STEPS greedy
    steps at per-row positions, twice: as they are, and with a row parked
    (``extract_cache_row``, ``clear_cache_row``) for SERVE_PARK_STEPS steps
    and merged back; every row's tokens must be equal in the two runs.
    (b) Jamba (no experts) and RWKV6-7B at full width, 8 layers: the same
    prefill check through K4 (and K1) and K6, then a few greedy steps; the
    same check again in fp32 at SERVE_TOL_F32.
    (c) InternLM2-1.8B at full size through ``DFLOPEngine(...).profile(...)
    .serving(backend="real")``, in fp32 (a bf16 product rounds differently
    at another batch size, so bf16 tokens would not survive a change of
    decode bucket), a single-image -> video stream under "slo" and "fifo":
    every request completes, SERVE_SAMPLED requests' tokens equal their solo
    greedy runs.  K1, K4 and K6 are counted over each prefill (from a reset
    just before it), compared with their plain versions and timed at the
    serve shapes; their rows go into ``timing``, ``launches`` and
    ``max_err``."""
    import numpy as np
    import torch
    F = torch.nn.functional

    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs import (internvl2_2b, jamba_v0_1_52b,
                                     llava_ov_qwen7b, rwkv6_7b)
    from repro_torch.core.engine import DFLOPEngine
    from repro_torch.data.items import DataItem
    from repro_torch.data.synthetic import MixedDataset
    from repro_torch.kernels import bench, mamba_scan, rwkv6_scan
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.models import model
    from repro_torch.models.layers.attention import kv_cache_bytes
    from repro_torch.quickstart import CLUSTER
    from repro_torch.runtime.drift import PageHinkley
    from repro_torch.serve import (Request, ServeConfig, clear_cache_row,
                                   extract_cache_row, make_decode_step,
                                   make_prefill_step, merge_cache_row,
                                   prefill_into_cache)

    bf16 = torch.bfloat16
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev).manual_seed(13)

    def counts():
        """Launches since the last reset: K1-K3 by key, K4-K7 by kernel."""
        return {"pfa": dict(pfa.LAUNCHES), "K4": mamba_scan.LAUNCHES["fwd"],
                "K5": mamba_scan.LAUNCHES["bwd"], "K6": rwkv6_scan.LAUNCHES["fwd"],
                "K7": rwkv6_scan.LAUNCHES["bwd"]}

    def prompts(vocab, lens):
        """Seeded prompts right-padded (token 0) to the longest."""
        toks = np.zeros((len(lens), max(lens)), np.int32)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.integers(2, vocab, n)
        return torch.as_tensor(toks, device=dev)

    def init(cfg):
        t0 = time.perf_counter()
        params = model.init(cfg, seed=0, device=dev)
        n = sum(p.numel() for p in tree_leaves(params))
        torch.cuda.synchronize()
        return params, n, time.perf_counter() - t0

    def prefill_vs_decode(tag, cfg, params, toks, lens, tol=SERVE_TOL, kv_dtype=bf16):
        """The kernel prefill's last-token logits (launches counted from a
        reset just before it) held against teacher-forced decode of each
        row at its exact length, within ``tol``.  Returns (the counts, the
        rows' (logits, B=1 cache), prefill ms, seconds a teacher-forced
        token)."""
        prefill = make_prefill_step(cfg)
        batch = {"tokens": toks, "lengths": torch.as_tensor(lens, device=dev)}
        for mod in (pfa, mamba_scan, rwkv6_scan):
            mod.reset_launches()
        got = prefill(params, batch)[:, 0]
        torch.cuda.synchronize()
        n = counts()
        t0 = time.perf_counter()
        rows = [prefill_into_cache(cfg, params, toks[b:b + 1, :m], max_len=m,
                                   kv_dtype=kv_dtype) for b, m in enumerate(lens)]
        torch.cuda.synchronize()
        tf_s = (time.perf_counter() - t0) / sum(lens)
        want = torch.cat([lg for lg, _ in rows])
        errs = rel_errors([f"row {b} (S {m})" for b, m in enumerate(lens)], list(got),
                          list(want))
        tol_max, tol_rel = tol
        ok = all(e <= tol_max * m and rel <= tol_rel for e, m, rel in errs.values())
        same = (torch.argmax(got, -1) == torch.argmax(want, -1)).tolist()
        log(f"[serve] {tag} prefill (kernels) vs teacher-forced decode, last-token logits: "
            + ", ".join(f"{k} max|err| {e:.3e} (tol {tol_max * m:.3e} = {tol_max:.0e} x "
                        f"max|decode| {m:.3e}), ||err||/||decode|| {rel:.3e} (tol {tol_rel:.0e})"
                        for k, (e, m, rel) in errs.items())
            + f"; argmax equal by row {same}" + (" OK" if ok else " FAIL"))
        if not ok:
            raise SystemExit(f"serve {tag}: the kernel prefill disagrees with decode")
        prefill_ms = cuda_ms(lambda: prefill(params, batch), 3, 1)
        return n, rows, prefill_ms, tf_s

    def greedy(cfg, params, rows, lens, steps, ctx_len, park=None):
        """``steps`` greedy steps of the prefilled B=1 caches ``rows`` merged
        into one batch of ``ctx_len`` tokens a row, at per-row positions.
        ``park`` = (row, at, n): that row leaves at step ``at`` (extracted,
        then cleared) and is merged back ``n`` steps later.  Returns (the
        tokens fed, by row; seconds by step)."""
        B = len(rows)
        caches = model.init_cache(cfg, B, ctx_len, bf16, device=dev)
        tok = np.zeros(B, np.int64)
        pos = np.asarray(lens, np.int64).copy()
        for b, (lg, c) in enumerate(rows):
            merge_cache_row(caches, c, row=b)
            tok[b] = int(torch.argmax(lg[0]))
        decode = make_decode_step(cfg)
        out, secs, parked = [[] for _ in range(B)], [], None
        for t in range(steps):
            if park is not None and t == park[1]:
                r = park[0]
                parked = (extract_cache_row(caches, r), tok[r], pos[r])
                clear_cache_row(caches, r)
                tok[r] = pos[r] = 0
            if park is not None and t == park[1] + park[2]:
                merge_cache_row(caches, parked[0], row=park[0])
                tok[park[0]], pos[park[0]] = parked[1], parked[2]
                parked = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = decode(params, caches, torch.as_tensor(tok, device=dev),
                                    torch.as_tensor(pos, device=dev))
            nxt = torch.argmax(logits, -1).tolist()
            secs.append(time.perf_counter() - t0)
            for b in range(B):
                if parked is not None and b == park[0]:
                    continue
                out[b].append(int(tok[b]))
                tok[b], pos[b] = nxt[b], pos[b] + 1
        return out, secs

    def add_row(kn, shape, n_launch, err, ms, plain_ms, t_ops_s, nbytes, lib_ms, note):
        t_ops, t_bytes = t_ops_s * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        timing[(kn, shape)] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=lib_ms,
            library_note=note)
        launches[(kn, shape)] = n_launch
        max_err[(kn, shape)] = err
        r = timing[(kn, shape)]
        lib = "none" if lib_ms is None else f"{lib_ms:.3f} ms"
        log(f"[timing] {kn} {shape}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {100 * r['bound_ms'] / ms:.1f} % of it), "
            f"library {lib} ({note}); {n_launch} launches on the serve path")

    def k1_row(shape, B, KH, G, S, D, n_launch):
        """K1 at a serve prefill shape (bf16, causal, one segment a row, as
        ``make_prefill_step`` runs it): against its plain version, timed
        beside it, its bound and SDPA."""
        rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf16)  # noqa: E731
        q, k, v = rnd(B, KH, G, S, D), rnd(B, KH, S, D), rnd(B, KH, S, D)
        seg = torch.zeros(B, S, dtype=torch.int32, device=dev)
        with torch.no_grad():
            o = [pfa.packed_flash_attention_bkgsd(q, k, v, seg, seg, causal=True, block_q=256,
                                                  block_k=256, plain=p) for p in (False, True)]
        errs = rel_errors(("o",), o[:1], o[1:])
        check_pair(f"{shape} K1 (B={B} KH={KH} G={G} S={S} D={D} bf16 causal)", errs, bf16)
        H = KH * G
        qs = q.reshape(B, H, S, D)
        ms = cuda_ms(lambda: pfa.flash_fwd(q, k, v, seg, seg, True, 0, 256, 256), 10)
        plain_ms = cuda_ms(lambda: pfa.fwd_plain(q, k, v, seg, seg, True, 0, 256, 256), 3, 1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, k, v, is_causal=True,
                                                                enable_gqa=G > 1), 10)
        ops_ = 4.0 * D * H * B * S * (S + 1) / 2        # QKᵀ and PV over the causal pairs
        e = q.element_size()
        nbytes = 2 * q.numel() * e + 2 * k.numel() * e + seg.numel() * 4 + B * H * S * 4
        add_row("K1", shape, n_launch, errs["o"][0], ms, plain_ms, ops_ / PEAK_BF16,
                nbytes, lib_ms, "SDPA, causal (one segment a row)")

    def check_k1(tag, n, want):
        """The prefill's K1 launches: ``want``, all on the tensor cores, and
        no K2/K3."""
        key = ("fwd", pfa.TENSOR_CORE, 128, True)
        k1 = n["pfa"].get(key, 0)
        other = {k: c for k, c in n["pfa"].items() if k != key}
        if k1 != want or other:
            raise SystemExit(f"serve {tag}: K1 launched {k1} times on the tensor cores (want "
                             f"{want}), other attention launches {other}")
        return k1

    # (a) Qwen2.5-7B, full size ------------------------------------------- #
    qcfg = dataclasses.replace(llava_ov_qwen7b.LLM, param_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    params, n_params, init_s = init(qcfg)
    log(f"[serve] qwen2.5-7b: {n_params / 1e9:.3f} B params (bf16), {qcfg.n_layers} layers of "
        f"d{qcfg.d_model}, {qcfg.n_heads} heads of {qcfg.head_dim} over {qcfg.n_kv_heads} kv, "
        f"vocab {qcfg.vocab_size}; init {init_s:.1f} s")
    lens = list(SERVE_QWEN_LENS)
    n, _, prefill_ms, tf_s = prefill_vs_decode("qwen2.5-7b", qcfg, params,
                                                prompts(qcfg.vocab_size, lens), lens)
    n_k1 = check_k1("qwen2.5-7b", n, qcfg.n_layers)
    log(f"[serve] qwen2.5-7b prefill of {len(lens)} prompts right-padded to {max(lens)} "
        f"(lengths {lens}): {prefill_ms:.3f} ms, {sum(lens) / prefill_ms * 1e3:.0f} prompt "
        f"tokens/s; K1 launches {n_k1}; teacher-forced decode {tf_s * 1e3:.3f} ms a prompt "
        f"token (B 1)")
    lens8 = [int(x) for x in rng.integers(8, 33, SERVE_ROWS)]
    toks8 = prompts(qcfg.vocab_size, lens8)
    t0 = time.perf_counter()
    rows = [prefill_into_cache(qcfg, params, toks8[b:b + 1, :m], max_len=m, kv_dtype=bf16)
            for b, m in enumerate(lens8)]
    torch.cuda.synchronize()
    handoff_s = time.perf_counter() - t0
    ctl, secs = greedy(qcfg, params, rows, lens8, SERVE_STEPS, SERVE_CTX)
    parked, _ = greedy(qcfg, params, rows, lens8, SERVE_STEPS, SERVE_CTX,
                       park=(SERVE_PARK_ROW, SERVE_PARK_AT, SERVE_PARK_STEPS))
    n_parked = SERVE_STEPS - SERVE_PARK_STEPS
    same = all(parked[b] == (ctl[b][:n_parked] if b == SERVE_PARK_ROW else ctl[b])
               for b in range(SERVE_ROWS))
    step_s = float(np.mean(secs[2:]))
    log(f"[serve] qwen2.5-7b decode: {SERVE_ROWS} rows (prompts {lens8}, teacher-forced in "
        f"{handoff_s:.2f} s, merged into a cache of {SERVE_CTX} tokens a row, "
        f"{SERVE_ROWS * kv_cache_bytes(qcfg, SERVE_CTX) / 1e9:.3f} GB of bf16 KV), "
        f"{SERVE_STEPS} greedy steps at per-row positions: {step_s * 1e3:.3f} ms a step "
        f"(steps 2+, host clock), {SERVE_ROWS / step_s:.1f} tokens/s; row "
        f"{SERVE_PARK_ROW} parked at step {SERVE_PARK_AT} for {SERVE_PARK_STEPS} steps and "
        f"merged back: every row's tokens equal the unparked run's: {same}; row 0 "
        f"{ctl[0][:8]} ...; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not same:
        raise SystemExit("serve qwen2.5-7b: parking and merging a row changed the tokens")
    del params, rows
    torch.cuda.empty_cache()
    k1_row("serve-qwen2.5-7b", len(lens), qcfg.n_kv_heads, qcfg.n_heads // qcfg.n_kv_heads,
           max(lens), qcfg.head_dim, n_k1)

    # (b) Jamba and RWKV6-7B, full width, 8 layers ------------------------- #
    lens = list(SERVE_SSM_LENS)
    B, S = len(lens), max(lens)
    for tag, cfg in (("jamba", dataclasses.replace(
            jamba_v0_1_52b.CFG, n_layers=DEC_LAYERS, ffn_pattern=("dense",),
            param_dtype="bfloat16")),
                     ("rwkv6-7b", dataclasses.replace(rwkv6_7b.CFG, n_layers=DEC_LAYERS,
                                                      param_dtype="bfloat16"))):
        torch.cuda.reset_peak_memory_stats()
        params, n_params, init_s = init(cfg)
        toks = prompts(cfg.vocab_size, lens)
        n, rows, prefill_ms, tf_s = prefill_vs_decode(tag, cfg, params, toks, lens)
        kinds = [k.value for k in cfg.layer_kinds]
        scan = "K6" if tag == "rwkv6-7b" else "K4"
        want = kinds.count("rwkv6" if tag == "rwkv6-7b" else "mamba")
        if n[scan] != want or n["K5"] or n["K7"]:
            raise SystemExit(f"serve {tag}: {scan} launched {n[scan]} times (want {want}); "
                             f"{n}")
        n_k1 = check_k1(tag, n, kinds.count("attention"))
        out, secs = greedy(cfg, params, rows, lens, 8, 512)
        step_s = float(np.mean(secs[2:]))
        log(f"[serve] {tag}: {n_params / 1e9:.3f} B params (bf16), layers {kinds}; prefill of "
            f"{B} prompts (lengths {lens}) {prefill_ms:.3f} ms, {scan} launches {n[scan]}, "
            f"K1 {n_k1}; teacher-forced decode {tf_s * 1e3:.3f} ms a prompt token (B 1); 8 "
            f"greedy steps at B {B}: {step_s * 1e3:.3f} ms a step, {B / step_s:.1f} tokens/s, "
            f"row 0 {out[0]}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, rows
        # the same prompts in fp32 (K1, K4, K6 on their fp32 routes)
        cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        params, _, _ = init(cfg32)
        prefill_vs_decode(f"{tag} fp32", cfg32, params, toks, lens, SERVE_TOL_F32,
                          torch.float32)
        del params
        torch.cuda.empty_cache()
        if tag == "jamba":
            di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_d_state
            u = torch.randn(B, S, di, generator=gen, device=dev).to(bf16)
            dt = F.softplus(torch.randn(B, S, di, generator=gen, device=dev) - 4).to(bf16)
            Bt, Ct = (torch.randn(B, S, N, generator=gen, device=dev).to(bf16)
                      for _ in range(2))
            A = -torch.arange(1, N + 1, device=dev, dtype=torch.float32).expand(di, N).contiguous()
            D = torch.ones(di, device=dev)
            with torch.no_grad():
                y = [mamba_scan.mamba_scan_bsd(u, dt, Bt, Ct, A, D, plain=p)
                     for p in (False, True)]
            errs = rel_errors(("y",), y[:1], y[1:])
            check_pair(f"serve {tag} K4 (B={B} S={S} di={di} N={N} bf16)", errs, bf16)
            ms = cuda_ms(lambda: mamba_scan.scan_fwd(u, dt, Bt, Ct, A, D, mamba_scan.CHUNK), 10)
            p_ms = cuda_ms(lambda: mamba_scan.fwd_plain(u, dt, Bt, Ct, A, D, mamba_scan.CHUNK),
                           1, 0)
            add_row("K4", f"serve-{tag}", n["K4"], errs["y"][0], ms, p_ms,
                    bench.mamba_flops(B, S, di, N) / PEAK_FP32,
                    bench.mamba_fwd_bytes(B, S, di, N, 2), None,
                    "none: no PyTorch call computes a selective scan")
            k1_row(f"serve-{tag}", B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, S,
                   cfg.head_dim, n_k1)
        else:
            H, M = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            r, k, v = (torch.randn(B, H, S, M, generator=gen, device=dev).to(bf16)
                       for _ in range(3))
            w = torch.exp(-torch.exp(-6 + 5 * torch.rand(B, H, S, M, generator=gen,
                                                         device=dev)))
            uu = torch.randn(H, M, generator=gen, device=dev) * 0.1
            with torch.no_grad():
                y = [rwkv6_scan.rwkv6_scan_bhsm(r, k, v, w, uu, plain=p) for p in (False, True)]
            errs = rel_errors(("y", "s_final"), y[0], y[1])
            check_pair(f"serve {tag} K6 (B={B} H={H} S={S} M={M} bf16)", errs, bf16)
            ms = cuda_ms(lambda: rwkv6_scan.wkv_fwd(r, k, v, w, uu, rwkv6_scan.CHUNK), 10)
            p_ms = cuda_ms(lambda: rwkv6_scan.fwd_plain(r, k, v, w, uu, rwkv6_scan.CHUNK), 1, 0)
            add_row("K6", f"serve-{tag}", n["K6"], max(e for e, _, _ in errs.values()), ms,
                    p_ms, bench.rwkv6_fwd_ops(B, H, S, M) / PEAK_FP32,
                    bench.rwkv6_fwd_bytes(B, H, S, M, 2), None,
                    "none: no PyTorch call computes a WKV6 recurrence")
        torch.cuda.empty_cache()

    # (c) InternLM2-1.8B through DFLOPEngine.serving(backend="real") -------- #
    lcfg = dataclasses.replace(internvl2_2b.LLM, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    params, n_params, init_s = init(lcfg)
    eng = DFLOPEngine(llm_cfg=internvl2_2b.LLM, cluster=CLUSTER,
                      tokens_per_media_item=SERVE_TPM)
    t0 = time.perf_counter()
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=SERVE_TPM), n_samples=256)
    prof_s = time.perf_counter() - t0
    half = SERVE_REQS // 2
    items = [DataItem(int(rng.integers(1, 3)), int(rng.integers(4, 17)), "single_image", i)
             if i < half else
             DataItem(int(rng.integers(4, 9)), int(rng.integers(8, 17)), "video", i)
             for i in range(SERVE_REQS)]
    scfg = ServeConfig(n_prefill_workers=1, n_decode_workers=1, decode_slots=SERVE_ROWS,
                       max_prefill_batch=4)

    def requests(arrivals, slos):
        return [Request(item=it, arrival_s=float(t), slo_s=float(s),
                        max_new_tokens=SERVE_NEW) for it, t, s in zip(items, arrivals, slos)]

    probe_reqs = requests([0.0] * SERVE_REQS, [1e9] * SERVE_REQS)

    def engine(policy):
        t0 = time.perf_counter()
        serve = eng.serving(admission=policy, serve_cfg=scfg, backend="real",
                            model_params=params, model_cfg=lcfg, max_len=SERVE_MAX_LEN,
                            chunk=16, trace=False,
                            drift=PageHinkley(delta=0.005, threshold=0.5, burn_in=8))
        serve.backend.probe(probe_reqs, n_shapes=4, n_obs=1)
        return serve, time.perf_counter() - t0

    served = {"slo": engine("slo")}
    serve = served["slo"][0]
    unit = serve.backend.unit_costs
    pricer, handoff = serve.pricer, serve.backend.handoff_s_mean()
    # SLOs and the arrival rate in measured units, as fig22 derives them; the
    # stream arrives at the measured service capacity (load 1.0)
    slos = [15.0 * unit["decode_step_s"]
            + 3.0 * (pricer.price(r) + handoff + pricer.decode_estimate(r)) for r in probe_reqs]
    t_req = float(np.mean([len(serve.backend.prompt_for(r)) * unit["prefill_s_per_tok"]
                           + SERVE_NEW * unit["decode_step_s"] / SERVE_ROWS
                           for r in probe_reqs]))
    arrivals = np.cumsum(rng.exponential(t_req, size=SERVE_REQS))
    log(f"[serve] internlm2-1.8b: {n_params / 1e9:.3f} B params (fp32), profiled in "
        f"{prof_s:.1f} s; real backend unit costs (warmup, host clock): "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in unit.items())
        + f"; {SERVE_REQS} requests ({half} single-image, then video), max_len "
        f"{SERVE_MAX_LEN}, {SERVE_NEW} new tokens each, an arrival every {t_req:.3f} s "
        f"on average")
    reqs = {}
    for policy in ("slo", "fifo"):
        if policy not in served:
            served[policy] = engine(policy)
        serve, setup_s = served[policy]
        reqs[policy] = requests(arrivals, slos)
        t0 = time.perf_counter()
        rep = serve.run(reqs[policy])
        wall = time.perf_counter() - t0
        cells = serve.calibrator.snapshot()
        errs = [abs(c / a - 1.0) for m, c, a in serve.prediction_log if m == "prefill" and a > 0]
        q = max(len(errs) // 4, 1)
        log(f"[serve] internlm2-1.8b {policy}: completed {rep.n_completed}/{SERVE_REQS}, "
            f"goodput {rep.goodput_rps:.4f} req/s, p99 latency {rep.p99_latency_s:.4f} s, "
            f"p50 {rep.p50_latency_s:.4f} s, SLO met {rep.n_slo_met}, drift (re-price) "
            f"events {rep.n_drift_events}, pricer flushes {serve.pricer.n_flushes}, "
            f"calibrated cells {len(cells)} ({', '.join(sorted(cells))}), prefill "
            f"|corrected/actual - 1| median early {np.median(errs[:q]):.3f} late "
            f"{np.median(errs[-q:]):.3f}; prefill batches {rep.n_prefill_batches}, decode "
            f"steps {rep.n_decode_steps}, mean occupancy {rep.mean_occupancy:.3f}; served in "
            f"{wall:.1f} s wall (engine, warmup and probe {setup_s:.1f} s)")
        short = [r.item.item_id for r in reqs[policy] if len(r.generated) != SERVE_NEW]
        if rep.n_completed != SERVE_REQS or short:
            raise SystemExit(f"serve internlm2-1.8b {policy}: not every request completed "
                             f"({rep.n_completed}/{SERVE_REQS}, short: {short})")
    decode = make_decode_step(lcfg)
    for i in [0, 1, half, half + 1][:SERVE_SAMPLED]:
        prompt = torch.as_tensor(serve.backend.prompt_for(reqs["slo"][i])[None], device=dev)
        logits, caches = prefill_into_cache(lcfg, params, prompt, SERVE_MAX_LEN)
        solo, pos = [], prompt.shape[1]
        tok = torch.argmax(logits, -1)
        for _ in range(SERVE_NEW):
            solo.append(int(tok[0]))
            logits, caches = decode(params, caches, tok, pos)
            tok, pos = torch.argmax(logits, -1), pos + 1
        got = {p: reqs[p][i].generated for p in reqs}
        log(f"[serve] internlm2-1.8b request {i} ({items[i].modality}, prompt "
            f"{prompt.shape[1]} tokens): solo {solo[:8]} ...; equal to the served tokens: "
            + ", ".join(f"{p} {g == solo}" for p, g in got.items()))
        if any(g != solo for g in got.values()):
            raise SystemExit(f"serve internlm2-1.8b: request {i}'s tokens differ from its "
                             f"solo greedy run")
    log(f"[serve] internlm2-1.8b max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, served, serve, caches
    torch.cuda.empty_cache()


def phase_dist(dev, timing, launches, max_err, q_batch, vl_batch, check_routes):
    """Phase 14: the distributed core under NCCL at a world of 1.

    (a) InternLM2-1.8B (the quickstart's LLM) at full width and depth: its
    24 layers stacked (``stack_layers``, ``stack_stage_params``) and run
    through ``pipeline_forward`` over ``build_stage_fn(model.layer_fn)``
    (checkpointed layers, as ``model.forward`` trains) on a ("stage",) mesh
    of one, on the 4 microbatches of the quickstart's first batch (embedded
    tokens, (1, 8192) packed rows with their positions and segment ids);
    forward and backward against the sequential loop over the same layers:
    output, loss, gradient norm and gradients (stacked layers and input)
    within PATH_TOL, and whether they are bitwise equal; K1-K3 launches of
    the pipeline run by route (all on the tensor cores).  (b) InternVL2-2B
    at full size on phase 5's first batch: the gradients of both
    microbatches through ``make_loss_fn(communicator=...)`` (encoder batch
    over ("data", "model"), LLM's over ("data",) on a 1x1 host mesh) against
    the same without the hook, then one ``make_train_step(communicator=...)``
    step.  (c) ``explicit_gather_scatter`` on the card, the vocab-parallel
    CE at model size 1 (None, as in the reference), and InternVL2-2B's
    parameter and optimizer-state specs on the 1x1 mesh and a stand-in
    16x16.  The process group is destroyed at the end."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.common.pytree import global_norm, tree_leaves, tree_map, tree_paths
    from repro_torch.configs import internvl2_2b
    from repro_torch.core.communicator import explicit_gather_scatter, make_communicator
    from repro_torch.core.pipeline.executor import (build_stage_fn, pipeline_forward,
                                                    stack_layers, stack_stage_params)
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.launch.mesh import make_host_mesh, make_mesh, mesh_shape
    from repro_torch.models import mllm, model
    from repro_torch.models.layers import embed
    from repro_torch.models.model import FwdCtx
    from repro_torch.sharding import (AxisAssignment, ModuleAssignment, opt_state_specs,
                                      param_specs)
    from repro_torch.sharding.vocab_ce import make_vocab_parallel_ce
    from repro_torch.train import optim, step

    t_phase = time.perf_counter()
    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            host = make_host_mesh((1, 1))
            stage = make_mesh((1,), ("stage",))
            log(f"[dist] NCCL world {dist.get_world_size()} (backend "
                f"{dist.get_backend()}); host mesh {mesh_shape(host)}, stage mesh "
                f"{mesh_shape(stage)}; {time.perf_counter() - t_phase:.2f} s")

            # (a) InternLM2-1.8B's 24 layers through the pipeline executor
            cfg = internvl2_2b.LLM
            params = model.init(cfg, seed=0, device=dev)
            flat = stack_layers([tree_map(lambda a: a.detach(), lp) for lp in params["layers"]])
            stacked = tree_map(lambda a: a.requires_grad_(True), stack_stage_params(flat, 1))
            del flat
            b = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in q_batch.items()}
            with torch.no_grad():
                mbs = embed.encode(params["embed"], b["tokens"], torch.bfloat16)
            mbs.requires_grad_(True)
            pos, seg = b["positions"], b["segment_ids"]
            del params
            torch.cuda.empty_cache()
            fn = model.layer_fn(cfg, FwdCtx())
            n = cfg.n_layers
            m = mbs.shape[0]
            gen = torch.Generator(device=dev).manual_seed(14)
            cot = torch.randn(mbs.shape, generator=gen, device=dev) / mbs[0].numel() ** 0.5
            leaves = tree_leaves(stacked)
            log(f"[dist] pipeline: {cfg.name}, {n} layers of d{cfg.d_model} (KH "
                f"{cfg.n_kv_heads}, G {cfg.n_heads // cfg.n_kv_heads}, D {cfg.head_dim}), "
                f"{sum(a.numel() for a in leaves) / 1e9:.3f} B stacked params (fp32, "
                f"compute bf16); m {m} microbatches of {tuple(mbs.shape[1:3])} tokens, "
                f"segments per microbatch {[len(torch.unique(s)) for s in seg]}")

            def run(tag, forward):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                pfa.reset_launches()
                t0 = time.perf_counter()
                out = forward()
                loss = (out.float() * cot).sum()
                loss.backward()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                res = {"out": out.detach(), "loss": loss.item(), "s": secs,
                       "peak": torch.cuda.max_memory_allocated() / 2**30,
                       "launches": dict(pfa.LAUNCHES),
                       "grads": [a.grad for a in leaves] + [mbs.grad]}
                for a in leaves + [mbs]:
                    a.grad = None
                log(f"[dist] {tag}: forward + backward {secs:.3f} s, loss {res['loss']:.6f}, "
                    f"peak {res['peak']:.2f} GiB, K1-K3 launches (kernel, route, head_dim, "
                    f"causal) {res['launches']}")
                return res

            pipe = pipeline_forward(stage, build_stage_fn(fn, n))
            # in turns: pipeline (the first call, set-up included), sequential,
            # pipeline; the second pipeline run is compared and counted
            first = run("pipeline_forward (1 stage), first call", lambda: pipe(stacked, mbs,
                                                                               pos, seg))
            check_routes("dist pipeline")

            def sequential():
                outs = []
                for i in range(m):
                    h = mbs[i]
                    for layer in range(n):
                        h = fn(tree_map(lambda a: a[0, layer], stacked), h, pos[i], seg[i])
                    outs.append(h)
                return torch.stack(outs)

            want = run("sequential loop", sequential)
            check_routes("dist sequential")
            got = run("pipeline_forward (1 stage)", lambda: pipe(stacked, mbs, pos, seg))
            check_routes("dist pipeline")
            repeat = torch.equal(first["out"], got["out"]) and all(
                torch.equal(a, b) for a, b in zip(first["grads"], got["grads"]))
            del first
            n_k = {kn: sum(c for key, c in got["launches"].items() if key[0] == COUNTER[kn]
                           and key[1] == pfa.TENSOR_CORE) for kn in COUNTER}
            if min(n_k.values()) == 0:
                raise SystemExit(f"dist: a kernel was not launched on the pipeline path: {n_k}")
            rels = {"loss": abs(got["loss"] - want["loss"]) / max(abs(want["loss"]), 1e-12),
                    "out": ((got["out"].float() - want["out"].float()).norm()
                            / want["out"].float().norm()).item()}
            gn_got, gn_want = global_norm(got["grads"]).item(), global_norm(want["grads"]).item()
            rels["grad_norm"] = abs(gn_got - gn_want) / gn_want
            rels["grads"] = global_norm([a - b for a, b in zip(got["grads"], want["grads"])]
                                        ).item() / gn_want
            rels["input grad"] = ((got["grads"][-1] - want["grads"][-1]).float().norm()
                                  / want["grads"][-1].float().norm()).item()
            bitwise = {"out": torch.equal(got["out"], want["out"]),
                       "grads": all(torch.equal(a, b) for a, b in
                                    zip(got["grads"], want["grads"]))}
            tol = {"loss": PATH_TOL["loss"], "out": PATH_TOL["grads"],
                   "grad_norm": PATH_TOL["grad_norm"], "grads": PATH_TOL["grads"],
                   "input grad": PATH_TOL["grads"]}
            log(f"[dist] pipeline vs sequential: " + ", ".join(
                f"{k} relative difference {v:.3e} (tol {tol[k]:.0e})" for k, v in rels.items())
                + f"; bitwise equal: output {bitwise['out']}, every gradient "
                f"{bitwise['grads']}; the two pipeline runs bitwise equal {repeat}; "
                f"pipeline {got['s']:.3f} s vs sequential "
                f"{want['s']:.3f} s; K1/K2/K3 pipeline {n_k['K1']}/{n_k['K2']}/{n_k['K3']}")
            if not all(math.isfinite(v) and v <= tol[k] for k, v in rels.items()):
                raise SystemExit("dist: the pipeline disagrees with the sequential loop")
            if not repeat:
                raise SystemExit("dist: two pipeline runs are not bitwise equal")
            for kn in COUNTER:
                launches[(kn, "dist")] = n_k[kn]
                timing[(kn, "dist")] = timing[(kn, "quickstart")]
                max_err[(kn, "dist")] = max_err[(kn, "quickstart")]
            del got, want, stacked, leaves, mbs, cot, pipe
            torch.cuda.empty_cache()

            # (b) InternVL2-2B through the Inter-model Communicator
            vcfg = internvl2_2b.CFG
            enc = AxisAssignment(batch=("data", "model"), tensor=())
            llm = AxisAssignment(batch=("data",), tensor=("model",))
            comm = make_communicator(host, enc, llm)
            vp = mllm.init(vcfg, seed=0, device=dev)
            named = tree_paths(vp)
            n_mb = next(iter(vl_batch.values())).shape[0]

            def grads_of(loss_fn):
                for _, p in named:
                    p.grad = None
                t0 = time.perf_counter()
                losses = []
                for i in range(n_mb):
                    loss = loss_fn(vp, {k: v[i] for k, v in vl_batch.items()})
                    loss.backward()
                    losses.append(loss.item())
                torch.cuda.synchronize()
                return losses, [p.grad for _, p in named], time.perf_counter() - t0

            # a first pass without the hook takes the set-up; then without, with
            grads_of(step.make_loss_fn(vcfg, FwdCtx()))
            plain_l, plain_g, plain_s = grads_of(step.make_loss_fn(vcfg, FwdCtx()))
            pfa.reset_launches()
            hook_l, hook_g, hook_s = grads_of(step.make_loss_fn(vcfg, FwdCtx(),
                                                                communicator=comm))
            hook_launches = dict(pfa.LAUNCHES)
            check_routes("dist communicator")
            gn = global_norm(plain_g).item()
            vrel = {"loss": max(abs(a - b) / abs(b) for a, b in zip(hook_l, plain_l)),
                    "grad_norm": abs(global_norm(hook_g).item() - gn) / gn,
                    "grads": global_norm([a - b for a, b in zip(hook_g, plain_g)]).item() / gn}
            same = hook_l == plain_l and all(torch.equal(a, b) for a, b in zip(hook_g, plain_g))
            log(f"[dist] InternVL2-2B, {n_mb} microbatches, communicator {enc.batch} -> "
                f"{llm.batch} on {mesh_shape(host)}: losses {hook_l} (without the hook "
                f"{plain_l}); " + ", ".join(f"{k} relative difference {v:.3e} (tol "
                                            f"{PATH_TOL[k]:.0e})" for k, v in vrel.items())
                + f"; bitwise equal {same}; {hook_s:.3f} s with the hook, {plain_s:.3f} s "
                f"without; K1-K3 launches {hook_launches}")
            if not all(math.isfinite(v) and v <= PATH_TOL[k] for k, v in vrel.items()):
                raise SystemExit("dist: the communicator hook changes InternVL2-2B's step")
            del plain_g, hook_g
            for _, p in named:
                p.grad = None
            torch.cuda.empty_cache()
            opt = optim.adamw_init(vp)
            train_step = step.make_train_step(vcfg, optim.AdamWConfig(), ctx=FwdCtx(),
                                              communicator=comm)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            vp, opt, met = train_step(vp, opt, vl_batch, 3e-4)
            step_loss = met["loss"].item()
            step_s = time.perf_counter() - t0
            want_loss = sum(hook_l) / n_mb
            log(f"[dist] InternVL2-2B make_train_step(communicator=...): loss {step_loss:.6f} "
                f"(the hook's microbatch mean {want_loss:.6f}), {step_s:.3f} s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if not abs(step_loss - want_loss) <= PATH_TOL["loss"] * abs(want_loss):
                raise SystemExit("dist: the step's loss is not its microbatches' mean")

            # (c) gather/scatter on the card, the vocab-parallel CE, the specs
            x = torch.randn(4, 8, 16, generator=gen, device=dev)
            y = explicit_gather_scatter(host, "data")(x)
            ce_none = {tied: make_vocab_parallel_ce(host, ("data",), ("model",),
                                                    vcfg.llm.vocab_size, tied) is None
                       for tied in (False, True)}
            log(f"[dist] explicit_gather_scatter on the card (NCCL all-gather) returns its "
                f"input: {torch.equal(x, y)}; make_vocab_parallel_ce(...) is None at model "
                f"size 1 (untied, tied): {ce_none[False]}, {ce_none[True]}")
            if not (torch.equal(x, y) and all(ce_none.values())):
                raise SystemExit("dist: gather/scatter or the vocab-parallel CE misbehaves")

            class StandIn:
                shape = {"data": 16, "model": 16}

            assign = ModuleAssignment(
                llm=AxisAssignment(batch=("data",), tensor=("model",), zero=("data",)),
                encoder=AxisAssignment(batch=("data", "model"), tensor=(), zero=("data",)))
            for name, mesh in (("1x1", host), ("16x16 stand-in", StandIn())):
                ps = param_specs(vp, assign, mesh)
                os_ = opt_state_specs(vp, ps, assign, mesh)
                count = {k: sum(any(e is not None for e in sp) for _, sp in tree_paths(t))
                         for k, t in (("params", ps), ("opt", os_))}
                total = len(tree_paths(ps))
                log(f"[dist] InternVL2-2B specs on {name}: params {count['params']} sharded, "
                    f"{total - count['params']} replicated; optimizer state {count['opt']} "
                    f"sharded, {total - count['opt']} replicated (of {total} leaves)")
            del vp, opt, train_step
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    log(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")



# Phase 15's chain of stage counts: InternLM2-1.8B's 24 layers divide by each
ELASTIC_PP = (1, 4, 2, 8, 3, 6, 1)


def phase_elastic(dev, timing, launches, max_err, q_batch, check_routes):
    """Phase 15: elastic execution's physical reshard under NCCL at a world of 1.

    (a) InternLM2-1.8B's 24 layers stacked in fp32 as in phase 14 (1.51 B
    parameters, 6.04 GB) with two AdamW moments of the same shapes (seeded,
    18.1 GB of state) through ``ParamSwapper(stage_stacked=True,
    mesh_factory=clamped_plan_mesh)`` over PP 1 -> 4 -> 2 -> 8 -> 3 -> 6 -> 1:
    each swap's seconds, GB/s (bytes moved over seconds) and peak allocated
    above what was allocated before it, ``estimate_cost_s`` before and after
    the first swap; every swap must move every byte and restack.  After each,
    ``pipeline_forward`` on the placed layers over the one-stage plan mesh
    (its block: all 24 layers), forward only, on the quickstart's first batch
    (K1 on the tensor cores): bitwise equal to the output before the chain.
    On one card a swap is a device-to-device copy leaf by leaf (the old leaf
    released before the next), no link traffic.  (b) The N -> N-1 -> N
    roster change (kill and revive) does not run here: it needs a rank a
    host, and NCCL refuses two ranks on one card; it runs on gloo ranks on
    the CPU (``tests/test_torch_elastic.py``).  The process group is destroyed
    at the end."""
    import functools
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.configs import internvl2_2b
    from repro_torch.core.optimizer.space import ModuleParallelism, ParallelismPlan
    from repro_torch.core.pipeline.executor import (build_stage_fn, pipeline_forward,
                                                    stack_layers, stack_stage_params)
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.reshard import ParamSwapper, clamped_plan_mesh
    from repro_torch.models import model
    from repro_torch.models.layers import embed
    from repro_torch.models.model import FwdCtx

    t_phase = time.perf_counter()
    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None else dev.index)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            cfg = internvl2_2b.LLM
            params = model.init(cfg, seed=0, device=dev)
            flat = stack_layers([tree_map(lambda a: a.detach(), lp) for lp in params["layers"]])
            b = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in q_batch.items()}
            with torch.no_grad():
                mbs = embed.encode(params["embed"], b["tokens"], torch.bfloat16)
            pos, seg = b["positions"], b["segment_ids"]
            del params
            layers = stack_stage_params(flat, 1)
            del flat
            gen = torch.Generator(device=dev).manual_seed(15)
            moments = [tree_map(lambda a: torch.randn(a.shape, generator=gen, device=dev),
                                layers) for _ in range(2)]
            live = {"state": (layers, *moments)}
            del layers, moments
            torch.cuda.empty_cache()
            state_bytes = sum(a.nbytes for a in tree_leaves(live["state"]))
            n_params = sum(a.numel() for a in tree_leaves(live["state"][0]))
            largest = max(a.nbytes for a in tree_leaves(live["state"]))
            fn = model.layer_fn(cfg, FwdCtx())
            n = cfg.n_layers

            def forward():
                """The placed layers on their plan mesh (plain stacks before
                the first swap, on a ("stage",) mesh of one)."""
                state = live["state"]
                mesh = one_stage if isinstance(state, tuple) else state.mesh
                pipe = pipeline_forward(mesh, build_stage_fn(fn, n))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    out = pipe(state[0], mbs, pos, seg)
                torch.cuda.synchronize()
                return out, time.perf_counter() - t0

            one_stage = make_mesh((1,), ("stage",))
            log(f"[elastic] NCCL world {dist.get_world_size()}; {cfg.name}'s {n} layers "
                f"stacked ({n_params / 1e9:.3f} B params, fp32) + 2 AdamW moments: "
                f"{state_bytes / 1e9:.3f} GB of state in {len(tree_leaves(live['state']))} "
                f"leaves, the largest {largest / 1e9:.3f} GB; {mbs.shape[0]} microbatches of "
                f"{tuple(mbs.shape[1:3])} tokens; {time.perf_counter() - t_phase:.1f} s")
            swapper = ParamSwapper(lambda: live["state"], lambda s: live.update(state=s),
                                   stage_stacked=True,
                                   mesh_factory=functools.partial(clamped_plan_mesh,
                                                                  device_type="cuda"))
            plans = [ParallelismPlan(llm=ModuleParallelism(1, pp, 1), n_mb=mbs.shape[0])
                     for pp in ELASTIC_PP]
            pfa.reset_launches()
            first, first_s = forward()
            log(f"[elastic] pipeline_forward before the chain (PP 1, plain stacks): "
                f"{first_s:.3f} s")
            rows = []
            for old, new in zip(plans, plans[1:]):
                est = swapper.estimate_cost_s(old, new)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                rep = swapper.swap(old, new)
                peak = torch.cuda.max_memory_allocated() - before
                after = torch.cuda.memory_allocated()
                out, fwd_s = forward()
                same = torch.equal(out, first)
                del out
                state = live["state"]
                rows.append(dict(pp=(old.llm.pp, new.llm.pp), s=rep.elapsed_s,
                                 gbps=rep.bytes_moved / rep.elapsed_s / 1e9, peak=peak,
                                 est=est, same=same, fwd_s=fwd_s))
                log(f"[elastic] swap PP {old.llm.pp} -> {new.llm.pp}: {rep.elapsed_s:.4f} s, "
                    f"{rep.bytes_moved / rep.elapsed_s / 1e9:.1f} GB/s ({rep.bytes_moved} of "
                    f"{rep.bytes_total} bytes moved, {rep.n_leaves} leaves, restacked "
                    f"{rep.restacked}); peak {peak / 1e9:.3f} GB above the {before / 1e9:.3f} "
                    f"GB allocated before it ({after / 1e9:.3f} GB after); estimate_cost_s "
                    f"before it {est:.4f} s; layout {state.layout}, local leaf shapes "
                    f"{[tuple(a.shape) for a in tree_leaves(state[0].tree)][:2]}...; "
                    f"pipeline_forward {fwd_s:.3f} s, bitwise equal to the first: {same}")
                if not (rep.bytes_moved == rep.bytes_total == state_bytes and rep.restacked):
                    raise SystemExit(f"elastic: swap {rep} did not move and restack every byte")
                if not same:
                    raise SystemExit(f"elastic: the output after PP {new.llm.pp} differs")
            n_k1 = sum(c for key, c in pfa.LAUNCHES.items() if key[0] == "fwd")
            check_routes("elastic")
            if n_k1 == 0:
                raise SystemExit("elastic: K1 was not launched on the chain's forwards")
            est_after = swapper.estimate_cost_s(plans[0], plans[1])
            secs = [r["s"] for r in rows]
            log(f"[elastic] {len(rows)} swaps of {state_bytes / 1e9:.3f} GB: seconds "
                f"{[round(x, 5) for x in secs]}, GB/s {[round(r['gbps'], 1) for r in rows]}, "
                f"peak above the state GB {[round(r['peak'] / 1e9, 3) for r in rows]}; "
                f"estimate_cost_s before the first swap {rows[0]['est']:.4f} s (NVLink 4 "
                f"default), after the chain {est_after:.4f} s (measured bandwidth); K1 "
                f"launches {n_k1} over {len(rows) + 1} forwards: {dict(pfa.LAUNCHES)}")
            launches[("K1", "elastic")] = n_k1
            timing[("K1", "elastic")] = timing[("K1", "quickstart")]
            max_err[("K1", "elastic")] = max_err[("K1", "quickstart")]
            del first, live, state, swapper, mbs
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    log(f"[elastic] phase {time.perf_counter() - t_phase:.1f} s")

# Phase 16's sharded layers.  The chip machine has one card and NCCL refuses
# two ranks on one device, so "world" gloo ranks share it (their tensors stay
# on the card; gloo stages each collective through host memory) on a
# ("data", "model") mesh of (1, 16), the reference's model axis: three MoE
# layers at full width in bf16 on T tokens at capacity factor E / k (nothing
# drops): Jamba-v0.1's 16 experts take the EP path (1 a rank), Granite's 40
# and Mixtral's 8 the TP-expert path (d_ff 32 and 896 a rank); Jamba's Mamba
# scan at full width (di 8192, 512 channels a rank; N 16), B 2 x S 4096 in
# fp32; then Mixtral-8x7B at full width cut to 2 layers under
# FwdCtx(shard_ctx, moe_impl="ep") on a (1, 4) mesh of ranks 0-3 (EP, 2
# experts a rank) on one 8192-token row of phase 12's batch.  "overrides"
# (arch -> ModelConfig fields) shrink the configs for a rehearsal on the CPU.
SHARD_PLAN = {
    "world": 16, "device": "cuda", "T": 4096,
    "layers": [["jamba-v0.1-52b", "ep"], ["granite-moe-3b-a800m", "tp"],
               ["mixtral-8x7b", "tp"]],
    "scan": {"arch": "jamba-v0.1-52b", "B": 2, "S": 4096},
    "model": {"arch": "mixtral-8x7b", "n_layers": MIXTRAL_LAYERS, "world": 4},
    "overrides": {},
}
# The sharded Mamba scan against the unsharded naive scan (fp32), max|err|
# over the oracle's largest element: the reference test's tolerances
SHARD_SCAN_TOL = {"y": 2e-5, "h": 2e-5, "grads": 2e-4}


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    import torch
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0


def _errs(a, b):
    """(max|a - b|, max|b|, ||a - b|| / ||b||), as ``rel_errors`` gives them."""
    d, b = a.float() - b.float(), b.float()
    return d.abs().max().item(), b.abs().max().item(), (d.norm() / b.norm()).item()


def _max_rel(a, b) -> float:
    """max|a - b| / max|b| (0 where both are all zero)."""
    d, m = (a.float() - b.float()).abs().max().item(), b.float().abs().max().item()
    return d / m if m > 0 else (0.0 if d == 0 else math.inf)


def shard_rank(rank: int, tmp: str) -> None:
    """One rank of phase 16 (``python3 chip_smoke.py --shard-rank K DIR``):
    reads ``DIR/plan.json``, joins the gloo group on ``DIR/store``, runs its
    share of every check of the phase and writes ``DIR/rank{K}.json`` (its
    paths, seconds, peaks and gradient norms; rank 0 also the comparisons
    with the oracles, which it runs on the whole layers).  Raises on any
    failure, so the rank exits non-zero."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.common.pytree import tree_leaves, tree_map, tree_paths
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.models.layers import mamba, moe
    from repro_torch.models.model import FwdCtx
    from repro_torch.sharding import AxisAssignment, ModuleAssignment, expert_shards
    from repro_torch.train import step

    with open(os.path.join(tmp, "plan.json")) as fh:
        plan = json.load(fh)
    world, dev = plan["world"], torch.device(plan["device"])
    torch.set_num_threads(1)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        build.load("packed_flash_attention")           # built by the parent

    def cfg_of(arch, **kw):
        return dc.replace(get_config(arch).desc, **plan["overrides"].get(arch, {}), **kw)

    t_rank = time.perf_counter()
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
                            rank=rank, world_size=world)
    rep = {"rank": rank, "layers": {}}
    try:
        mesh = make_mesh((1, world), ("data", "model"), device_type=dev.type)
        ctx = (mesh, ("data",), ("model",))
        assign = ModuleAssignment(llm=AxisAssignment(batch=("data",), tensor=("model",)))
        # rank 0 with rank k: a group of two that moves rank k's slices to rank 0
        pairs = {k: dist.new_group([0, k]) for k in range(1, world)}
        rep["setup_s"] = time.perf_counter() - t_rank

        def to_rank0(tensors, k):
            """Rank k's ``tensors`` on rank 0 (a broadcast in {0, k})."""
            out = []
            for t in tensors:
                buf = t.contiguous() if rank == k else torch.empty(t.shape, dtype=t.dtype,
                                                                   device=dev)
                dist.broadcast(buf, src=k, group=pairs[k])
                out.append(buf)
            return out

        def release():
            """Return this process's cached blocks to the card: the ranks
            share it, and no process can use another's cache."""
            if dev.type == "cuda":
                torch.cuda.empty_cache()

        def card_used():
            """GiB in use on the card by every process (0 on the CPU)."""
            if dev.type != "cuda":
                return 0.0
            free, total = torch.cuda.mem_get_info(dev)
            return (total - free) / 2**30

        def in_turns(fn, ranks):
            """``fn()`` on each of ``ranks`` in turn (whole-layer builds),
            every rank passing the same barriers."""
            for r in range(world):
                if rank == r and r in ranks:
                    fn()
                    release()
                dist.barrier()

        class Gap:
            """Σ||got - want||² and Σ||want||² by leaf name."""

            def __init__(self):
                self.err, self.ref = {}, {}

            def add(self, name, got, want):
                self.err[name] = self.err.get(name, 0.0) + (got.float() - want.float()
                                                            ).norm().item() ** 2
                self.ref[name] = self.ref.get(name, 0.0) + want.float().norm().item() ** 2

            def total(self):
                return math.sqrt(sum(self.err.values()) / sum(self.ref.values()))

            def by_leaf(self):
                return {n: math.sqrt(self.err[n] / max(self.ref[n], 1e-60)) for n in self.err}

        # (a) three MoE layers at full width: the sharded path on every rank,
        # the capacity path and the dense oracle on the whole layer (rank 0)
        for arch, want_path in plan["layers"]:
            cfg = cfg_of(arch)
            E, k, T = cfg.n_experts, cfg.top_k, plan["T"]
            cf = E / k
            held = {}

            def build_layer():
                full = moe.init(torch.Generator(device=dev).manual_seed(16), cfg,
                                dtype=torch.bfloat16)
                held["mine"] = {n: v.requires_grad_(True) for n, v in expert_shards(
                    {"l": {"moe": full}}, assign, mesh)["l"]["moe"].items()}
                if rank == 0:
                    held["full"] = {n: v.requires_grad_(True) for n, v in full.items()}

            in_turns(build_layer, range(world))
            mine = held["mine"]
            names = sorted(mine)
            x = torch.randn(1, T, cfg.d_model, generator=torch.Generator(device=dev)
                            .manual_seed(17), device=dev).to(torch.bfloat16)

            def run(params, impl):
                xg = x.clone().requires_grad_(True)
                for v in params.values():
                    v.grad = None
                _sync(dev)
                _reset_peak(dev)
                t0 = time.perf_counter()
                y, lb, st = moe.apply(params, xg, cfg, impl=impl, capacity_factor=cf,
                                      shard_ctx=ctx if impl == "ep" else None,
                                      with_stats=True)
                loss = 0.5 * y.float().square().mean() + step.LB_LOSS_WEIGHT * lb
                loss.backward()
                _sync(dev)
                return dict(s=time.perf_counter() - t0, peak=_peak_gib(dev), y=y.detach(),
                            loss=loss.detach(), drop=st["drop_rate"].item(),
                            grads=dict(x=xg.grad, **{n: params[n].grad for n in names}))

            # an EP layer runs twice (whether the runs are bitwise equal is
            # reported), a TP layer once
            dist.barrier()
            first = run(mine, "ep")
            same = None
            if want_path == "ep":
                dist.barrier()
                got = run(mine, "ep")
                same = torch.equal(first["y"], got["y"]) and all(
                    torch.equal(first["grads"][n], got["grads"][n]) for n in got["grads"])
            else:
                got = first
            del first
            dist.barrier()
            used = card_used()                   # every rank's sharded run cached
            release()
            lay = rep["layers"][arch] = dict(
                path=moe.sharded_path(cfg, world), want=want_path, E=E, top_k=k,
                d=cfg.d_model, d_ff=cfg.d_ff, T=T, cf=cf, s=got["s"], peak=got["peak"],
                bitwise=same, stats_nan=math.isnan(got["drop"]), card_used=used,
                slices={n: list(mine[n].shape) for n in names},
                norms={n: got["grads"][n].float().norm().item() for n in ("x", "router")}
                | {"y": got["y"].float().norm().item()})
            dist.barrier()
            if rank == 0:
                oracles = {impl: run(held["full"], impl) for impl in ("capacity", "dense")}
                lay["oracle_s"] = {i: o["s"] for i, o in oracles.items()}
                lay["oracle_peak"] = max(o["peak"] for o in oracles.values())
                lay["drop"] = oracles["capacity"]["drop"]
                lay["y"] = {i: _errs(got["y"], o["y"]) for i, o in oracles.items()}
                lay["loss"] = {i: abs(got["loss"].item() - o["loss"].item())
                               / abs(o["loss"].item()) for i, o in oracles.items()}
                gaps = {i: Gap() for i in oracles}
                for i, o in oracles.items():
                    for n in ("x", "router"):
                        gaps[i].add(n, got["grads"][n], o["grads"][n])
            for kk in range(world):
                if rank not in (0, kk):
                    continue
                part = [got["grads"][n] for n in names if n != "router"]
                if kk:
                    part = to_rank0(part, kk)
                if rank == 0:
                    for i, o in oracles.items():
                        cut = expert_shards({"l": {"moe": {n: o["grads"][n] for n in names}}},
                                            assign, mesh, coords={"data": 0, "model": kk})
                        for n, g in zip([n for n in names if n != "router"], part):
                            gaps[i].add(n, g, cut["l"]["moe"][n])
                    del part
            if rank == 0:
                lay["grads"] = {i: g.total() for i, g in gaps.items()}
                lay["grads_by_leaf"] = {i: g.by_leaf() for i, g in gaps.items()}
                del oracles, gaps
            del held, mine, got, x
            release()
            dist.barrier()

        # (b) Jamba's Mamba scan at full width: sharded over channels on every
        # rank; the unsharded naive scan on rank 0 first (its graph freed
        # before the sharded ones are built)
        sc = plan["scan"]
        jcfg = cfg_of(sc["arch"])
        di, N, B, S = mamba.dims(jcfg)[0], jcfg.ssm_d_state, sc["B"], sc["S"]
        gen = torch.Generator(device=dev).manual_seed(18)

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        ins = [rnd(B, S, di), torch.nn.functional.softplus(rnd(B, S, di)), rnd(B, S, N),
               rnd(B, S, N), -torch.exp(0.3 * rnd(di, N)), rnd(di)]
        cot_y, cot_h = rnd(B, S, di) / math.sqrt(B * S * di), rnd(B, di, N) / math.sqrt(B * di * N)
        msize = world
        chans = slice(rank * di // msize, (rank + 1) * di // msize)

        def scan(fn, sl):
            leaves = [a.clone().requires_grad_(True) for a in ins]
            _sync(dev)
            _reset_peak(dev)
            t0 = time.perf_counter()
            y, h = fn(*leaves)
            loss = (y * cot_y).sum() + (h * cot_h[:, sl]).sum()
            loss.backward()
            _sync(dev)
            return dict(s=time.perf_counter() - t0, peak=_peak_gib(dev), y=y.detach(),
                        h=h.detach(), grads=[a.grad for a in leaves])

        if rank == 0:
            oracle = scan(mamba.ssm_scan_xla, slice(None))
            release()
        dist.barrier()
        got = scan(lambda *a: mamba.ssm_scan_sharded(*a, ctx), chans)
        dist.barrier()
        used = card_used()
        hs = [torch.empty_like(got["h"]) for _ in range(msize)]
        dist.all_gather(hs, got["h"].contiguous(), group=mesh.get_group("model"))
        rep["scan"] = dict(di=di, N=N, B=B, S=S, s=got["s"], peak=got["peak"], card_used=used,
                           h_shape=list(got["h"].shape))
        if rank == 0:
            rep["scan"]["oracle_s"], rep["scan"]["oracle_peak"] = oracle["s"], oracle["peak"]
            rep["scan"]["y"] = _max_rel(got["y"], oracle["y"])
            rep["scan"]["h"] = _max_rel(torch.cat(hs, 1), oracle["h"])
            rep["scan"]["grads"] = {n: _max_rel(a, b) for n, a, b in zip(
                ("u", "dt", "B", "C", "A", "D"), got["grads"], oracle["grads"])}
            del oracle
        del ins, got, hs, cot_y, cot_h
        release()
        dist.barrier()

        # (c) Mixtral-8x7B, 2 layers at full width, under FwdCtx(shard_ctx,
        # moe_impl="ep") on ranks 0-3, then rank 0's single-process step on
        # the whole model (after ranks 1-3 keep only their expert gradients)
        mp = plan["model"]
        m_world = mp["world"]
        mesh4 = make_mesh((1, m_world), ("data", "model"), ranks=list(range(m_world)),
                          device_type=dev.type)
        mcfg = cfg_of(mp["arch"], n_layers=mp["n_layers"])
        batch = {kk: torch.as_tensor(v, device=dev) for kk, v in
                 np.load(os.path.join(tmp, "model_batch.npz")).items()}
        held = {}

        def build_model():
            held["mine"] = expert_shards(model.init(mcfg, seed=0, device=dev), assign, mesh4)

        in_turns(build_model, range(m_world))
        if rank < m_world:
            mine = held.pop("mine")
            ctx4 = (mesh4, ("data",), ("model",))
            pfa.reset_launches()
            _sync(dev)
            _reset_peak(dev)
            t0 = time.perf_counter()
            loss = step.make_loss_fn(mcfg, FwdCtx(shard_ctx=ctx4, moe_impl="ep"))(mine, batch)
            loss.backward()
            _sync(dev)
            rep["model"] = dict(s=time.perf_counter() - t0, peak=_peak_gib(dev),
                                card_used=card_used(), loss=loss.item(),
                                path=moe.sharded_path(mcfg, m_world),
                                launches=[[*key, n] for key, n in pfa.LAUNCHES.items()],
                                n_params=sum(a.numel() for a in tree_leaves(mine)))
            del loss                          # its graph holds the leaves
            grads = {p: a.grad for p, a in tree_paths(mine)}
            experts = sorted(p for p in grads if "/moe/w_" in p)
            if rank:
                grads = {p: grads[p] for p in experts}
            del mine
            release()
        dist.barrier()
        if rank == 0:
            params = model.init(mcfg, seed=0, device=dev)
            _sync(dev)
            _reset_peak(dev)
            t0 = time.perf_counter()
            want_loss = step.make_loss_fn(mcfg, FwdCtx())(params, batch)
            want_loss.backward()
            _sync(dev)
            rep["model"].update(oracle_loss=want_loss.item(), oracle_s=time.perf_counter() - t0,
                                oracle_peak=_peak_gib(dev))
            want_loss = want_loss.item()      # its graph holds the leaves
            oracle = tree_map(lambda a: a.grad, params)
            del params
            release()
            want = dict(tree_paths(oracle))
            gap, got2 = Gap(), 0.0
            for p, g in grads.items():
                if p not in experts:
                    gap.add(p, g, want[p])
                    got2 += g.float().norm().item() ** 2
        for kk in range(m_world):
            if rank not in (0, kk):
                continue
            part = [grads[p] for p in experts]
            if kk:
                part = to_rank0(part, kk)
            if rank == 0:
                cut = dict(tree_paths(expert_shards(oracle, assign, mesh4,
                                                    coords={"data": 0, "model": kk})))
                for p, g in zip(experts, part):
                    gap.add(p, g, cut[p])
                    got2 += g.float().norm().item() ** 2
                del cut
            del part
        if rank == 0:
            want_norm = math.sqrt(sum(gap.ref.values()))
            rep["model"]["rel"] = {
                "loss": abs(rep["model"]["loss"] - want_loss) / abs(want_loss),
                "grad_norm": abs(math.sqrt(got2) - want_norm) / want_norm,
                "grads": gap.total()}
            del oracle, want
        grads = None
        held.clear()
        release()
        dist.barrier()
    finally:
        rep["rank_s"] = time.perf_counter() - t_rank
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(rep, fh)
        dist.destroy_process_group()


# Seconds the parent waits for phase 16's ranks
SHARD_TIMEOUT_S = 900


def phase_shard(dev, timing, launches, max_err, model_batch, plan=None):
    """Phase 16: the sharded layer paths (``moe.apply_ep_shard_map``,
    ``moe._apply_tp_shard_map``, ``mamba.ssm_scan_sharded``,
    ``FwdCtx.shard_ctx``) on ``plan["world"]`` gloo ranks that share the card
    (``SHARD_PLAN``; each rank is ``shard_rank`` in a process of its own, on a
    ``FileStore`` in a temporary directory).  ``model_batch``: the row the
    Mixtral model check trains on ({name: (1, S)}).  Prints each rank's path,
    seconds and peak and rank 0's comparisons; fails if a rank fails or
    exits non-zero, or on any mismatch."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import packed_flash_attention as pfa

    plan = plan or SHARD_PLAN
    world, m_world = plan["world"], plan["model"]["world"]
    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
        log(f"[shard] before the ranks start: this process holds "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, "
            f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved; the card "
            f"{(total - free) / 2**30:.2f} of {total / 2**30:.2f} GiB in use")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "plan.json"), "w") as fh:
            json.dump(plan, fh)
        np.savez(os.path.join(tmp, "model_batch.npz"), **model_batch)
        # expandable segments: a rank's freed pages go back to the card even
        # where a kept slice shares the segment a whole layer was drawn in
        # (the ranks share one card; no process can use another's cache)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
                   PYTHONPATH=os.pathsep.join(filter(None, [os.path.join(HERE, "src"),
                                                            os.environ.get("PYTHONPATH")])))
        logs = [open(os.path.join(tmp, f"rank{k}.log"), "w") for k in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shard-rank",
                                   str(k), tmp], stdout=logs[k], stderr=subprocess.STDOUT,
                                  env=env, cwd=HERE) for k in range(world)]
        deadline, first = time.monotonic() + SHARD_TIMEOUT_S, []
        try:
            while any(p.poll() is None for p in procs):
                first = [k for k, p in enumerate(procs) if p.poll() not in (None, 0)]
                if first or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for f in logs:
                f.close()
        failed = [k for k, p in enumerate(procs) if p.returncode != 0]
        if failed:
            # the first rank to fail, and every rank whose log says more than
            # that a peer went away
            log(f"[shard] exit codes {[p.returncode for p in procs]}; first to fail {first}")
            for k in failed:
                with open(os.path.join(tmp, f"rank{k}.log")) as fh:
                    text = fh.read()
                if k in first or "closed by peer" not in text:
                    log(f"[shard] rank {k} exited {procs[k].returncode}:\n{text[-6000:]}")
            raise SystemExit(f"shard: ranks {failed} failed or timed out "
                             f"({SHARD_TIMEOUT_S} s)")
        reps = []
        for k in range(world):
            with open(os.path.join(tmp, f"rank{k}.json")) as fh:
                reps.append(json.load(fh))
    r0 = reps[0]
    fmt = lambda xs, spec=".3f": "[" + ", ".join(f"{x:{spec}}" for x in xs) + "]"  # noqa: E731
    log(f"[shard] {world} gloo ranks on {dev} ({'one card' if dev.type == 'cuda' else 'cpu'}),"
        f" a (1, {world}) ('data', 'model') mesh; set-up per rank (gloo group, mesh, "
        f"{world - 1} pair groups) {fmt([r['setup_s'] for r in reps], '.1f')} s")
    ok = True

    def check(cond, what):
        nonlocal ok
        if not cond:
            ok = False
            log(f"[shard] FAIL: {what}")

    # (a) the MoE layers
    tol_max, tol_rel = TOL["bfloat16"]
    for arch, want_path in plan["layers"]:
        lays = [r["layers"][arch] for r in reps]
        a = lays[0]
        paths = sorted({x["path"] for x in lays}, key=str)
        log(f"[shard] {arch} MoE layer: E {a['E']} top-{a['top_k']}, d {a['d']}, d_ff "
            f"{a['d_ff']}, T {a['T']} tokens, bf16, capacity factor {a['cf']:g} (oracle drop "
            f"{a['drop']}); path on every rank {paths} (want {want_path}); rank 0's leaves "
            f"{a['slices']}; forward + backward s per rank "
            f"({'second call' if a['bitwise'] is not None else 'first call, set-up included'})"
            f" {fmt([x['s'] for x in lays])}; "
            f"peak GiB per rank {fmt([x['peak'] for x in lays], '.2f')} (rank 0 also holds "
            f"the whole layer; the card: {a['card_used']:.1f} GiB in use after the sharded "
            f"runs); " + (f"two sharded runs bitwise equal on every rank: "
                          f"{all(x['bitwise'] for x in lays)} (by rank "
                          f"{[x['bitwise'] for x in lays]}; reported only); "
                          if a["bitwise"] is not None else "")
            + f"rank 0's whole-layer oracles "
            f"{ {i: round(s, 3) for i, s in a['oracle_s'].items()} } s, peak "
            f"{a['oracle_peak']:.2f} GiB")
        for i in ("capacity", "dense"):
            e, m, rel = a["y"][i]
            log(f"[shard] {arch} sharded vs {i}: y max|err| {e:.3e} (tol {tol_max * m:.3e}), "
                f"||err||/||y|| {rel:.3e} (tol {tol_rel:.0e}); loss relative "
                f"{a['loss'][i]:.3e} (tol {PATH_TOL['loss']:.0e}); ||g - g_{i}|| / ||g_{i}|| "
                f"{a['grads'][i]:.3e} (tol {PATH_TOL['grads']:.0e}; by leaf "
                + ", ".join(f"{n} {v:.2e}" for n, v in a["grads_by_leaf"][i].items()) + ")")
            check(e <= tol_max * m and rel <= tol_rel and a["loss"][i] <= PATH_TOL["loss"]
                  and a["grads"][i] <= PATH_TOL["grads"], f"{arch} disagrees with {i}")
        check(paths == [want_path], f"{arch}: paths {paths}, want {want_path}")
        check(a["drop"] == 0.0, f"{arch}: the oracle dropped {a['drop']}")
        check(all(x["stats_nan"] for x in lays), f"{arch}: a rank's stats are not NaN")
        for n in ("x", "router", "y"):
            v0 = a["norms"][n]
            check(all(abs(x["norms"][n] - v0) <= 1e-6 * v0 for x in lays),
                  f"{arch}: the replicated {n} differs across ranks "
                  f"{[x['norms'][n] for x in lays]}")

    # (b) the Mamba scan
    sc = r0["scan"]
    log(f"[shard] Jamba Mamba scan, di {sc['di']} ({sc['h_shape'][1]} channels a rank), N "
        f"{sc['N']}, B {sc['B']}, S {sc['S']}, fp32, ssm_scan_sharded (naive inner scan): "
        f"forward + backward s per rank {fmt([r['scan']['s'] for r in reps])}, peak GiB per "
        f"rank {fmt([r['scan']['peak'] for r in reps], '.2f')} (the card: {sc['card_used']:.1f} "
        f"GiB in use after them); rank 0's unsharded "
        f"ssm_scan_xla {sc['oracle_s']:.3f} s, peak {sc['oracle_peak']:.2f} GiB; max|err| / "
        f"max|oracle|: y {sc['y']:.3e}, h {sc['h']:.3e} (tol {SHARD_SCAN_TOL['y']:.0e}), "
        f"gradients " + ", ".join(f"{n} {v:.3e}" for n, v in sc["grads"].items())
        + f" (tol {SHARD_SCAN_TOL['grads']:.0e})")
    check(sc["y"] <= SHARD_SCAN_TOL["y"] and sc["h"] <= SHARD_SCAN_TOL["h"]
          and max(sc["grads"].values()) <= SHARD_SCAN_TOL["grads"],
          "the sharded Mamba scan disagrees with the unsharded one")

    # (c) Mixtral's 2 layers on ranks 0-3
    mreps = [r["model"] for r in reps[:m_world]]
    m0 = mreps[0]
    n_k = []
    for mr in mreps:
        by = {}
        for *key, n in mr["launches"]:
            by[tuple(key)] = by.get(tuple(key), 0) + n
        n_k.append({kn: sum(n for key, n in by.items() if key[0] == COUNTER[kn]
                            and key[1] == pfa.TENSOR_CORE) for kn in COUNTER})
        off = {key: n for key, n in by.items() if key[1] != pfa.TENSOR_CORE}
        check(not off, f"model: K1-K3 launches off the tensor cores: {off}")
        if dev.type == "cuda":
            check(min(n_k[-1].values()) > 0, f"model: a kernel was not launched: {n_k[-1]}")
    log(f"[shard] {plan['model']['arch']}, {plan['model']['n_layers']} layers at full width, "
        f"FwdCtx(shard_ctx, moe_impl='ep') on a (1, {m_world}) mesh of ranks 0-{m_world - 1}: "
        f"path {[mr['path'] for mr in mreps]}; params a rank "
        f"{fmt([mr['n_params'] / 1e9 for mr in mreps])} B; loss {m0['loss']:.6f} (rank 0's "
        f"single-process capacity path {m0['oracle_loss']:.6f}); forward + backward s per rank "
        f"(first call, set-up included) {fmt([mr['s'] for mr in mreps])} (single process "
        f"after it {m0['oracle_s']:.3f} s); peak GiB "
        f"per rank {fmt([mr['peak'] for mr in mreps], '.2f')} (the card: "
        f"{max(mr['card_used'] for mr in mreps):.1f} GiB in use; single process "
        f"{m0['oracle_peak']:.2f}); " + ", ".join(
            f"{key} relative {v:.3e} (tol {PATH_TOL[key]:.0e})" for key, v in m0["rel"].items())
        + f"; K1/K2/K3 tensor-core launches by rank "
        f"{[[n[kn] for kn in COUNTER] for n in n_k]}")
    check(all(mr["path"] == "ep" for mr in mreps), "model: not the EP path")
    check(all(v <= PATH_TOL[key] for key, v in m0["rel"].items()),
          "model: the sharded step disagrees with the single-process step")
    check(len({mr["loss"] for mr in mreps}) == 1, f"model: the ranks' losses differ "
          f"{[mr['loss'] for mr in mreps]}")
    log(f"[shard] phase {time.perf_counter() - t_phase:.1f} s (ranks' own "
        f"{fmt([r['rank_s'] for r in reps], '.1f')} s)")
    if not ok:
        raise SystemExit("shard: a check failed")
    if dev.type == "cuda":
        for kn in COUNTER:
            launches[(kn, "shard")] = sum(n[kn] for n in n_k)
            timing[(kn, "shard")] = timing[(kn, "mixtral")]
            max_err[(kn, "shard")] = max_err[(kn, "mixtral")]


# Phase 17: the three drivers as ``python -m`` processes, and the lines each
# must print (the reference's)
DRIVERS = {
    "plan_inspector": [r"^\[theta\*\] encoder \(tp=\d+", r"^\[theta\*\] expected makespan",
                       r"^\[baselines\]", r"^ +tp= ?\d+ pp=\d: makespan"],
    "serve_decode": [r"^tiny-swa +generated", r"^tiny-hybrid +generated",
                     r"^tiny-rwkv +generated"],
    "serve_mllm": [r"^request A done", r"^request B done", r"^request C done",
                   r"^fifo +goodput", r"^slo +goodput",
                   r"^real backend \(.*\): (\d+)/\1 completed"],
}


# Phase 18's production dry runs; each runs as its own process (fake tensors
# on the host's cores), all side by side, and must end within
# DRYRUN_TIMEOUT_S.  Wanted, in order: internvl2-2b train_4k, mixtral-8x7b
# train_4k, jamba 2x16x16 train_4k, deepseek-7b decode_32k, one prefill_32k.
# The phase keeps those that fit its budget: a run's host seconds grow with
# layers x microbatches, and with 8 of them side by side Mixtral's took
# 342 s and Jamba's longer (PERF.md §6); those two are in
# tools/dryrun_sweep.py's sweep instead.
DRYRUN_COMBOS = [("internvl2-2b", "train_4k", False), ("deepseek-7b", "decode_32k", False),
                 ("gemma-2b", "prefill_32k", False)]
DRYRUN_TIMEOUT_S = 300
DRYRUN_TOL = 0.01          # grounding: argument bytes and FLOPs, relative


def phase_dryrun(dev, cfg, batch, combos=DRYRUN_COMBOS, timeout_s=DRYRUN_TIMEOUT_S):
    """Phase 18 (see the module doc): ``cfg`` and ``batch`` (numpy, leading
    microbatch axis) are phase 12(e)'s gemma-2b step."""
    import torch
    import torch.distributed as dist
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model
    from repro_torch.models.model import FwdCtx
    from repro_torch.sharding.partition import P
    from repro_torch.train import optim, step
    t_phase = time.perf_counter()

    # (a) grounding: the same step for real, then on fake tensors at 1x1
    lr = 3e-4
    params = model.init(cfg, seed=0, device=dev)
    opt = optim.adamw_init(params)
    b = step.as_tensors(batch, device=dev)
    live = sum(t.numel() * t.element_size() for t in
               tree_leaves(params) + tree_leaves(opt["m"]) + tree_leaves(opt["v"])
               + list(b.values()))
    train_step = step.make_train_step(cfg, optim.AdamWConfig(), ctx=FwdCtx())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    real = hlo_stats.analyze(lambda: train_step(params, opt, b, lr))
    torch.cuda.synchronize()
    real_s, real_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    del params, opt, b
    torch.cuda.empty_cache()
    started = D.start_fake_group(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        with D._fake_mode():
            p = model.init(cfg, seed=0, device=dev)
            specs = tree_map(lambda _: P(), p)         # one rank holds everything
            o = optim.adamw_init(p)
            fparams = D._placed_tree(p, specs, mesh, requires_grad=True)
            fopt = {"m": D._placed_tree(o["m"], specs, mesh),
                    "v": D._placed_tree(o["v"], specs, mesh), "step": 0}
            fb = {k: D._sds(tuple(v.shape), torch.int32, mesh, P(), dev)
                  for k, v in batch.items()}
            built = D.Built(lambda p_, o_, b_: train_step(p_, o_, b_, lr), (fparams, fopt, fb),
                            {}, in_place=(fparams, fopt),
                            loops={"microbatches": len(next(iter(batch.values()))),
                                   "llm_layers": cfg.n_layers})
            mem, fake, trace_s = D.trace_step(built)
    finally:
        if started:
            dist.destroy_process_group()
    arg_gap = abs(mem["argument_bytes"] - live) / live
    flop_gap = abs(fake.flops - real.flops) / real.flops
    log(f"[dryrun] grounding gemma-2b (phase 12(e)'s step, 1x1 mesh): argument bytes "
        f"{mem['argument_bytes']} vs live {live} (gap {arg_gap:.2e}, tol {DRYRUN_TOL}); "
        f"FLOPs {fake.flops:.6e} vs the real step's {real.flops:.6e} (gap {flop_gap:.2e}, "
        f"tol {DRYRUN_TOL}); HBM bytes {fake.hbm_bytes:.4e} vs {real.hbm_bytes:.4e}; "
        f"predicted peak {mem['peak_per_chip'] / 2**30:.2f} GiB vs max_memory_allocated "
        f"{real_peak / 2**30:.2f} GiB (gap {(mem['peak_per_chip'] - real_peak) / 2**30:+.2f} "
        f"GiB); real step {real_s:.2f} s under the recorder, fake run {trace_s:.1f} s")
    if arg_gap > DRYRUN_TOL or flop_gap > DRYRUN_TOL:
        raise SystemExit("dryrun: the grounding step disagrees with the real one")

    # (b) production meshes, side by side
    out_dir = os.path.join(HERE, "build", "dryrun_smoke")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")])))
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for arch, shape, mp in combos:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", out_dir, "--device", dev.type] + (
            ["--multi-pod"] if mp else [])
        # output to a file: a pipe nobody reads while it runs would fill and stall it
        logf = open(os.path.join(out_dir, f"{arch}__{shape}.log"), "w+")
        procs.append((arch, shape, mp, time.perf_counter(), logf, subprocess.Popen(
            cmd, env=env, cwd=HERE, stdout=logf, stderr=subprocess.STDOUT)))
    failed, ended = [], {}
    while len(ended) < len(procs) and time.perf_counter() - t_phase < timeout_s:
        for i, (*_, proc) in enumerate(procs):
            if i not in ended and proc.poll() is not None:
                ended[i] = time.perf_counter()
        time.sleep(0.5)
    for i, (arch, shape, mp, t0, logf, proc) in enumerate(procs):
        if proc.poll() is None:
            proc.kill()
            failed.append(f"{arch} {shape}: over {timeout_s} s")
        proc.wait()
        logf.seek(0)
        out = logf.read()
        logf.close()
        for ln in out.splitlines():
            if ln.startswith("[dryrun]"):
                log(f"[dryrun] {arch} {shape} | {ln}")
        mesh_name = "2x16x16" if mp else "16x16"
        path = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
        if proc.returncode != 0 or not os.path.exists(path):
            failed.append(f"{arch} {shape} {mesh_name}: exit {proc.returncode}")
            tb = ""
            if os.path.exists(path):
                with open(path) as f:
                    tb = json.load(f).get("traceback", "")
            log(tb or out[-3000:])
            continue
        with open(path) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            log(f"[dryrun] {arch} x {shape} x {mesh_name}: {rec['reason']}")
            continue
        hlo = rec["hlo"]
        log(f"[dryrun] {arch} x {shape} x {mesh_name}: exit 0 after "
            f"{ended[i] - t0:.1f} s (trace {rec['trace_s']} s); peak "
            f"{rec['memory']['peak_per_chip'] / 1e9:.2f} GB a rank, fits_80gb "
            f"{rec['fits_80gb']}; FLOPs a rank {hlo['flops']:.4e} (model FLOPs / ranks / "
            f"FLOPs {rec['model_flops'] / rec['n_chips'] / hlo['flops']:.3f}); collective "
            f"bytes {json.dumps(hlo['collective_bytes'])}")
    log(f"[dryrun] phase {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise SystemExit(f"dryrun: {failed}")


def phase_drivers(dev):
    """Phase 17: ``python -m repro_torch.{plan_inspector,serve_decode,
    serve_mllm}`` on ``dev`` (subprocesses, default arguments): each must
    exit 0 and print the reference's lines (``DRIVERS``; the real backend's
    ``completed n/n``)."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [
        os.path.join(HERE, "src"), os.environ.get("PYTHONPATH")])))
    for mod, patterns in DRIVERS.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"repro_torch.{mod}", "--device", dev.type],
                           capture_output=True, text=True, timeout=600, env=env, cwd=HERE)
        for ln in r.stdout.splitlines():
            log(f"[drivers] {mod} | {ln}")
        missing = [p for p in patterns if not re.search(p, r.stdout, re.M)]
        log(f"[drivers] {mod}: exit {r.returncode}, {time.perf_counter() - t0:.1f} s, "
            f"missing lines {missing}")
        if r.returncode != 0 or missing:
            log(r.stderr[-4000:])
            raise SystemExit(f"drivers: {mod} failed (exit {r.returncode}, missing {missing})")
    log(f"[drivers] phase {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np

    from repro_torch import quickstart
    from repro_torch import train_mllm as m100_loop
    from repro_torch.common.pytree import global_norm, tree_leaves, tree_paths
    from repro_torch.configs import (get_config, internvl2_2b, jamba_v0_1_52b,
                                     llava_ov_qwen7b, rwkv6_7b)
    from repro_torch.core.engine import DFLOPEngine
    from repro_torch.core.optimizer.space import ClusterSpec
    from repro_torch.core.profiling.analytic import H100, AnalyticBackend
    from repro_torch.data.packing import pack_items
    from repro_torch.data.synthetic import MixedDataset
    from repro_torch.kernels import bench, build, mamba_scan, rwkv6_scan
    from repro_torch.kernels import packed_flash_attention as pfa
    from repro_torch.models import mllm, model
    from repro_torch.models.layers import moe
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

    def path_dtype(sh):
        """The type a path shape trains in: bf16 but for the fp32 mllm-100m."""
        return sh.get("dtype", torch.bfloat16)

    def dtype_tag(sh):
        return "f32" if path_dtype(sh) == torch.float32 else "bf16"

    def seg_rows(S, lens):
        s = torch.zeros(len(lens), S, dtype=torch.int32)
        for i, n in enumerate(lens):
            s[i, :n] = 1
        return s

    # the decoders of phases 7-8 and their packed rows (numpy, seeded)
    rwkv_cfg = dataclasses.replace(rwkv6_7b.CFG, n_layers=DEC_LAYERS)
    # restarting at each packed segment, as the benchmark's Jamba trains
    jamba_cfg = dataclasses.replace(jamba_v0_1_52b.CFG, n_layers=DEC_LAYERS,
                                    ffn_pattern=("dense",), ssm_segment_reset=True)

    def decoder_batch(cfg, seed, n_mb=DEC_MB, S=DEC_S, rows=DEC_ROWS):
        """n_mb x rows rows of S tokens: items of the mixed data drawn
        until a row overflows, then packed (the overflow is truncated and
        counted by pack_items)."""
        ds = MixedDataset("mixed", seed=seed, tokens_per_media_item=DEC_TPM)
        rng = np.random.default_rng(seed)
        packed = []
        for _ in range(n_mb * rows):
            items = ds.sample(1)
            while sum(it.llm_seq_len(DEC_TPM) for it in items) < S:
                items += ds.sample(1)
            packed.append(pack_items(items, S, DEC_TPM, cfg.vocab_size, rng))
        return {k: np.stack([getattr(pb, k)[0] for pb in packed]).reshape(
            n_mb, rows, S) for k in ("tokens", "labels", "segment_ids",
                                     "positions")}

    dec_batches = {"rwkv6-7b": [decoder_batch(rwkv_cfg, s) for s in range(3)],
                   "jamba": [decoder_batch(jamba_cfg, 10 + s) for s in range(3)]}

    # phase 12's configurations, from the registry, and their batches (numpy,
    # seeded)
    granite_cfg = get_config("granite-moe-3b-a800m").desc
    mixtral_full = get_config("mixtral-8x7b").desc
    mixtral_cfg = dataclasses.replace(mixtral_full, n_layers=MIXTRAL_LAYERS)
    hubert_cfg = get_config("hubert-xlarge").desc
    gemma_cfg = get_config("gemma-2b").desc

    def hubert_batch(cfg, seed, n_mb=DEC_MB, rows=DEC_ROWS, S=DEC_S):
        """HuBERT's masked prediction: seeded frame embeddings (the stubbed
        feature extractor's), spans of 10 frames masked from 8 % of the
        frames (HuBERT's p and span), a unit label on each masked frame and
        -1 elsewhere; row 1 of each microbatch ends in 596 padding frames
        (segment 0, no labels)."""
        rng = np.random.default_rng(seed)
        emb = rng.standard_normal((n_mb, rows, S, cfg.input_embed_dim)).astype(np.float32)
        starts = rng.random((n_mb, rows, S)) < 0.08
        masked = starts.copy()
        for off in range(1, 10):
            masked[..., off:] |= starts[..., :-off]
        seg = np.ones((n_mb, rows, S), np.int32)
        seg[:, 1, S - 596:] = 0
        labels = np.where(masked & (seg > 0),
                          rng.integers(0, cfg.vocab_size, (n_mb, rows, S)), -1)
        return {"frame_embeds": emb, "labels": labels.astype(np.int32),
                "segment_ids": seg}

    arch_batches = {
        "granite": [decoder_batch(granite_cfg, 30 + s) for s in range(3)],
        "mixtral": [decoder_batch(mixtral_cfg, 40 + s, S=MIXTRAL_S, rows=1)
                    for s in range(3)],
        "hubert": [hubert_batch(hubert_cfg, 50 + s) for s in range(3)],
        "gemma": [decoder_batch(gemma_cfg, 60 + s, S=GEMMA_S) for s in range(3)],
    }

    def arch_shape(cfg, key, **kw):
        """The attention shape of phase 12's path ``key``: its first
        microbatch's rows and segments."""
        seg = torch.as_tensor(arch_batches[key][0]["segment_ids"][0])
        return dict(B=seg.shape[0], KH=cfg.n_kv_heads, G=cfg.n_heads // cfg.n_kv_heads,
                    S=seg.shape[1], D=cfg.head_dim, causal=cfg.causal, seg=seg, **kw)

    # the quickstart path of phase 10 (numpy): its first batch, drawn the same
    # way there; the microbatch with the most segments gives the attention
    # shape of that path timed in phase 4
    qsz = quickstart.CARD

    def quickstart_loader():
        qds = MixedDataset("mixed", seed=0, tokens_per_media_item=qsz.tokens_per_media_item)
        q_eng, q_res, q_prof_s, q_plan_s = quickstart.plan(qsz, qds)
        return quickstart.make_loader(qsz, q_eng, qds), q_res, q_prof_s, q_plan_s

    q_loader = quickstart_loader()[0]
    q_batch0 = next(iter(q_loader))           # (N_mb, 1, S) leaves; phase 14's pipeline
    q_first = q_batch0["segment_ids"][:, 0]                               # (N_mb, S)
    q_groups = q_loader.last_schedule.groups
    q_seg = q_first[int(np.argmax([len(np.unique(r)) for r in q_first]))]
    del q_loader
    log(f"[compare] quickstart row (the first batch's microbatch with the most segments): "
        f"tokens by segment id {dict(zip(*(a.tolist() for a in np.unique(q_seg, return_counts=True))))} "
        f"(0 = padding)")

    enc, llm_cfg = internvl2_2b.ENCODER, internvl2_2b.LLM
    S_ENC, S_LLM = 4096, 256 + 1024
    # phase 11's model, mllm-100m: the rows of microbatch 0 of a first batch of
    # the mix, GBS items in N_mb groups, as its loop builds them
    m100, n_mb100 = m100_loop.MCFG, m100_loop.LOCAL_PLAN.n_mb
    m100_ds = MixedDataset("mixed", seed=0, tokens_per_media_item=m100_loop.TPM)
    m100_mb = {k: v[0] for k, v in m100_loop.build_batches(
        m100_ds, m100_loop.LOCAL_PLAN, m100_ds.sample(m100_loop.GBS),
        [list(range(i, m100_loop.GBS, n_mb100)) for i in range(n_mb100)], n_mb100).items()}
    M100_ROWS = m100_mb["media_mask"].shape[0]
    # the connector pools the media window to tokens_per_item_out tokens
    M100_POOLED = m100_loop.MAX_MEDIA // (m100_loop.MAX_MEDIA // m100.tokens_per_item_out)
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
        # phase 12: Granite-MoE (G 3, D 64), Mixtral (G 4, D 128, window
        # 4096 over 8192-token rows), HuBERT (bidirectional, D 80 in a
        # 128-column tile), gemma-2b (MQA, G 8, D 256)
        "granite": arch_shape(granite_cfg, "granite"),
        "mixtral": arch_shape(mixtral_cfg, "mixtral", window=mixtral_cfg.window_size),
        "hubert": arch_shape(hubert_cfg, "hubert"),
        "gemma": arch_shape(gemma_cfg, "gemma"),
        # the reference's 100M MLLM (phase 11, fp32: the CUDA-core kernels):
        # microbatch 0 of its first batch, media -> {1 real, 0 padded tail}
        "mllm100m_encoder": dict(B=M100_ROWS, KH=m100.encoder.n_kv_heads,
                                 G=m100.encoder.n_heads // m100.encoder.n_kv_heads,
                                 S=m100_loop.MAX_MEDIA, D=m100.encoder.head_dim,
                                 causal=False, seg=torch.as_tensor(m100_mb["media_mask"]),
                                 dtype=torch.float32),
        # its LLM: the pooled media tokens (segment 1) + text, 0 past text_mask
        "mllm100m_llm": dict(B=M100_ROWS, KH=m100.llm.n_kv_heads,
                             G=m100.llm.n_heads // m100.llm.n_kv_heads,
                             S=M100_POOLED + m100_loop.MAX_TEXT, D=m100.llm.head_dim,
                             causal=True, seg=torch.as_tensor(np.concatenate(
                                 [np.ones((M100_ROWS, M100_POOLED), np.int32),
                                  m100_mb["text_mask"]], 1)),
                             dtype=torch.float32),
    }
    masked = seg_rows(200, [200])
    masked[:, :40] = 7                              # 40 rows attend nothing
    # rows of several packed segments (ids 1..5) and a padded tail (0): many
    # 64 x 64 tiles hold no attending pair, so the kernels' segment skip runs
    packed = torch.zeros(2, 300, dtype=torch.int32)
    for row, cuts in enumerate([(0, 50, 120, 121, 260, 300), (0, 64, 128, 200, 290)]):
        for i in range(len(cuts) - 1):
            packed[row, cuts[i]:cuts[i + 1]] = i + 1
    cases = {f"{n}/{dtype_tag(sh)}": make_case(sh["B"], sh["KH"], sh["G"], sh["S"], sh["D"],
                                               path_dtype(sh), sh["causal"],
                                               sh.get("window", 0), sh["seg"])
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
    phase_restarts(dev)

    # 4. timing ------------------------------------------------------------ #
    F = torch.nn.functional
    timing = {}
    for shape, sh in path_shapes.items():
        B, KH, G, S, D, causal = (sh[n] for n in ("B", "KH", "G", "S", "D", "causal"))
        H, win = KH * G, sh.get("window", 0)
        c = make_case(B, KH, G, S, D, path_dtype(sh), causal, win, sh["seg"])
        # the CUDA-core fp32 kernels are held to the fp32 peak (the route
        # refuses TF32), the tensor-core ones to bf16's
        peak = PEAK_FP32 if path_dtype(sh) == torch.float32 else PEAK_BF16
        q, k, v, do, seg = c["q"], c["k"], c["v"], c["do"], c["seg_q"]
        o, lse = pfa.flash_fwd(q, k, v, seg, seg, causal, win, 256, 256)
        delta = torch.sum(do.float() * o.float(), -1).contiguous()
        bargs = (q, k, v, seg, seg, do, lse, delta, causal, win)
        t = {
            "K1": cuda_ms(lambda: pfa.flash_fwd(q, k, v, seg, seg, causal, win, 256, 256), 10),
            "K2": cuda_ms(lambda: pfa.flash_bwd_dq(*bargs, 256, 256), 10),
            "K3": cuda_ms(lambda: pfa.flash_bwd_dkv(*bargs, 256, 256), 10),
        }
        plain = {
            "K1": cuda_ms(lambda: pfa.fwd_plain(q, k, v, seg, seg, causal, win, 256, 256), 3, 1),
            "K2": cuda_ms(lambda: pfa.bwd_dq_plain(*bargs, 256, 256), 3, 1),
            "K3": cuda_ms(lambda: pfa.bwd_dkv_plain(*bargs, 256, 256), 3, 1),
        }
        # the library yardstick: SDPA given the same mask as a boolean tensor
        qs = q.reshape(B, H, S, D)
        keep = seg[:, None, :, None] == seg[:, None, None, :]          # (B,1,S,S)
        if causal:
            keep = keep & torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        if win:
            keep = keep & torch.ones(S, S, dtype=torch.bool, device=dev).triu(-(win - 1))
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
            t_ops, t_bytes = ops_ / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            timing[(kn, shape)] = dict(
                ms=t[kn], plain_ms=plain[kn], bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=lib[kn],
                library_note=("SDPA with the same boolean mask" if kn == "K1" else
                              "SDPA backward (fwd+bwd - fwd), dq and dk/dv together"))
            r = timing[(kn, shape)]
            log(f"[timing] {kn} {shape} (B={B} KH={KH} G={G} S={S} D={D} {dtype_tag(sh)} "
                f"causal={causal} window={win}, {pfa.route_of(q.dtype)}): kernel "
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

    def check_routes(tag):
        """Fail unless every K1/K2/K3 launch since the last reset took the
        tensor cores (the training paths run in bf16)."""
        off = {key: n for key, n in pfa.LAUNCHES.items() if key[1] != pfa.TENSOR_CORE}
        if off:
            raise SystemExit(f"{tag}: K1-K3 launches off the tensor cores: {off}")
        log(f"[{tag}] every K1/K2/K3 launch took the tensor cores")

    def op_groups(events, cfg):
        """Device ms in the traced step by group, from each op's own kernels:
        the expert GEMMs (``bmm`` over the (E, ., .) expert batch), the MoE
        dispatch (``DISPATCH_OPS`` on tensors without the vocab axis) and the
        LM head (products with the vocab axis), forward, recompute and
        backward alike; an op takes the group of its nearest grouped
        ancestor."""
        E, V = cfg.n_experts, cfg.vocab_size

        def group_of(e):
            while e is not None:
                shapes = [tuple(x) for x in (e.input_shapes or []) if x]
                has_v = any(V in x for x in shapes)
                if E and e.name == "aten::bmm" and shapes and len(shapes[0]) == 3 \
                        and shapes[0][0] == E:
                    return "expert GEMMs"
                if has_v and e.name in ("aten::mm", "aten::bmm", "aten::addmm"):
                    return "LM head GEMMs"
                if E and e.name in DISPATCH_OPS and not has_v:
                    return "MoE dispatch"
                e = e.cpu_parent
            return "other"

        ms, n, other = {}, {}, {}
        for e in events:
            own = [k for k in getattr(e, "kernels", [])]
            if not own or e.device_type != torch.autograd.DeviceType.CPU:
                continue
            g = group_of(e)
            t = sum(k.duration for k in own) / 1e3
            ms[g] = ms.get(g, 0.0) + t
            n[g] = n.get(g, 0) + len(own)
            if g == "other":
                other[e.name] = other.get(e.name, 0.0) + t
        return ms, n, other

    def profile_step(fn, tag, shapes, step_s, scans=(), model_cfg=None):
        """Run ``fn`` (one train step) under torch.profiler and print the
        device time per kernel name for K1-K3 at each of ``shapes`` that has
        attention and for the bf16 scan kernels ``scans`` at ``shapes[0]``
        (beside the isolated time, phase 4), the ten kernels with the most
        device time, and
        the device's idle share: over the traced step (whose host side the
        profiler slows) and against ``step_s``, the untraced step's seconds.
        With ``model_cfg`` the trace records input shapes and ``op_groups``
        prints its device ms by group.  A trace with no device
        events prints "not measured"."""
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=model_cfg is not None) as prof:
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
            # shapes that run one instantiation (mllm-100m's encoder and LLM
            # both take fwd_kernel<64>) share a line: the trace cannot tell
            # their launches apart
            groups = {}
            for shape in (sh for sh in shapes if sh in path_shapes):   # attention shapes
                # the instantiation: tile width, and whether the head dim pads it
                D = path_shapes[shape]["D"]
                tile = next(w for w in (64, 128, 256) if D <= w)
                if path_dtype(path_shapes[shape]) == torch.float32:
                    key = ("re", FP32_TRACE[kn].format(t=tile))
                else:
                    key = ("in", f"<{tile}, {'true' if D < tile else 'false'}>")
                groups.setdefault(key, []).append(shape)
            for (how, pat), group in groups.items():
                if how == "re":
                    rx = re.compile(pat)
                    hits = [(nm, tot, n) for nm, (tot, n) in per_name.items()
                            if rx.search(nm)]
                else:
                    hits = [(nm, tot, n) for nm, (tot, n) in per_name.items()
                            if frag in nm and pat in nm]
                tot = sum(t for _, t, _ in hits)
                n = sum(c for _, _, c in hits)
                iso = ", ".join(f"{timing[(kn, sh)]['ms']:.3f}" for sh in group)
                if n:
                    log(f"[profile] {tag} {kn} {' + '.join(group)}: {tot / 1e3:.3f} ms device "
                        f"time over {n} launches in the step, {tot / 1e3 / n:.3f} ms per "
                        f"launch (isolated {iso} ms); {[nm[:60] for nm, _, _ in hits]}")
                else:
                    log(f"[profile] {tag} {kn} {' + '.join(group)}: no launch found in the "
                        f"trace")
        for kn in scans:
            sh = SCAN_SHAPES[shapes[0]]
            pat = re.compile(SCAN_TRACE[kn].format(n=sh["N"] if "N" in sh else sh["M"]))
            hits = [(nm, tot, n) for nm, (tot, n) in per_name.items() if pat.search(nm)]
            tot, n = sum(t for _, t, _ in hits), sum(c for _, _, c in hits)
            iso = timing[(kn, shapes[0])]["ms"]
            log(f"[profile] {tag} {kn}: {tot / 1e3:.3f} ms device time a step over {n} "
                f"launches, {tot / 1e3 / max(n, 1):.3f} ms per launch (isolated {iso:.3f} "
                f"ms); {[nm[:70] for nm, _, _ in hits]}")
        if model_cfg is not None:
            ms, n, other = op_groups(events, model_cfg)
            log(f"[profile] {tag} device ms by group in the step: " + ", ".join(
                f"{g} {ms[g]:.3f} ({n[g]} kernels)" for g in sorted(ms, key=lambda g: -ms[g]))
                + f"; their sum {sum(ms.values()):.3f} of the busy {busy / 1e3:.3f}; other, "
                "by op: " + ", ".join(f"{op} {t:.3f}" for op, t in sorted(
                    other.items(), key=lambda kv: -kv[1])[:8]))
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
        counts = {("K4", name): mamba_scan.LAUNCHES["fwd"],
                  ("K5", name): mamba_scan.LAUNCHES["bwd"],
                  ("K6", name): rwkv6_scan.LAUNCHES["fwd"],
                  ("K7", name): rwkv6_scan.LAUNCHES["bwd"]}
        for kn in COUNTER:
            counts[(kn, name)] = sum(n for (kk, route, _, _), n in pfa.LAUNCHES.items()
                                     if kk == COUNTER[kn]
                                     and route == pfa.route_of(torch.bfloat16))
        check_routes(f"decoders {name}")
        if cfg.ssm_segment_reset:
            rst = (mamba_scan.LAUNCHES["fwd_restarts"], mamba_scan.LAUNCHES["bwd_restarts"])
            log(f"[decoders] {name}: K4/K5 launches with restart words {rst[0]}/{rst[1]}")
            if rst != (counts[("K4", name)], counts[("K5", name)]) or not rst[0]:
                raise SystemExit(f"{name}: K4/K5 launched without restart words: {rst}")
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

    # 11. runtime: the closed control loop on the reference's 100M MLLM ---- #
    # (a) calibration from measured kernels: bench_kernel through the kernels'
    # fp32 entry points (K1, then K1+K2+K3; K4, K4+K5; K6, K6+K7), the
    # measured/analytic-H100 unit per kernel and direction, into a calibrator
    from repro_torch.runtime import OnlineCalibrator
    from repro_torch.train import checkpoint
    reset_counts()
    t0 = time.perf_counter()
    seqs = (1024, 2048, 4096, 8192)
    rows = (bench.bench_kernel("attention", seqs,
                               dims=dict(B=1, KH=8, G=2, D=128, causal=True))
            + bench.bench_kernel("mamba", seqs) + bench.bench_kernel("rwkv6", seqs))
    bench.normalize(rows)
    bench_s = time.perf_counter() - t0
    for r in rows:
        log(f"[runtime] bench {r['kernel']} {r['direction']} S {r['tokens']} (bucket "
            f"{r['bucket']}): measured {r['measured_s'] * 1e3:.4f} ms (iterations "
            f"{', '.join(f'{x * 1e3:.4f}' for x in r['times_s'])}), analytic H100 "
            f"{r['analytic_s'] * 1e3:.5f} ms, unit {r['unit']:.3f}, ratio {r['ratio']:.3f}")
    units = {(r["kernel"], r["direction"]): r["unit"] for r in rows}
    log(f"[runtime] bench units (measured / analytic H100, geomean over S): " + ", ".join(
        f"{k}/{d} {u:.3f}" for (k, d), u in units.items()) + f"; {bench_s:.1f} s")
    if not all(math.isfinite(r["ratio"]) and r["measured_s"] > 0 for r in rows):
        raise SystemExit("runtime: a bench row has no finite ratio")
    bench_launches = {"K1": sum(n for key, n in pfa.LAUNCHES.items() if key[0] == "fwd"),
                      "K2": sum(n for key, n in pfa.LAUNCHES.items() if key[0] == "bwd_dq"),
                      "K3": sum(n for key, n in pfa.LAUNCHES.items() if key[0] == "bwd_dkv"),
                      "K4": mamba_scan.LAUNCHES["fwd"], "K5": mamba_scan.LAUNCHES["bwd"],
                      "K6": rwkv6_scan.LAUNCHES["fwd"], "K7": rwkv6_scan.LAUNCHES["bwd"]}
    log(f"[runtime] bench launches: {bench_launches}; K1-K3 by key: {dict(pfa.LAUNCHES)}")
    if min(bench_launches.values()) == 0 or any(
            key[1] != pfa.CUDA_CORE for key in pfa.LAUNCHES):
        raise SystemExit(f"runtime: bench_kernel did not launch every kernel in fp32: "
                         f"{bench_launches}, {dict(pfa.LAUNCHES)}")
    cal = OnlineCalibrator()
    n_obs = bench.seed_calibrator(cal, rows)
    mature = sum(c.n >= cal.min_obs for c in cal.cells.values())
    log(f"[runtime] seeded calibrator: {n_obs} observations, {len(cal.cells)} cells, "
        f"{mature} mature: {json.dumps(cal.snapshot())}")
    if not (n_obs == sum(len(r["times_s"]) for r in rows) and mature == len(cal.cells) > 0):
        raise SystemExit("runtime: the calibrator was not seeded")

    # (b) train_mllm at mllm-100m, full size: the re-plan smoke over a data
    # shift, the lookahead composer, and the data-agnostic baseline
    m100_shapes = ("mllm100m_encoder", "mllm100m_llm")
    trace_path = os.path.join(HERE, "build", "runtime_trace.json")
    ckpt_path = os.path.join(HERE, "build", "runtime_ckpt")
    m100_launches = {(kn, shape): 0 for kn in COUNTER for shape in m100_shapes}
    m100_steps = 0
    from repro_torch.launch.reshard import ParamSwapper, Placed

    def state_bits(state):
        """The (params, opt) tensors, fp32 read as int32 (bitwise)."""
        tree = state.tree if isinstance(state, Placed) else state
        return [a.detach().view(torch.int32) if a.dtype == torch.float32 else a.detach()
                for a in tree_leaves(tree) if isinstance(a, torch.Tensor)]

    class CheckedSwapper(ParamSwapper):
        """The trainer's swapper, holding each swap's (params, opt) against a
        copy taken before it, bitwise."""
        same = []

        def swap(self, old_plan, new_plan):
            before = [a.clone() for a in state_bits(self._get())]
            rep = super().swap(old_plan, new_plan)
            after = state_bits(self._get())
            CheckedSwapper.same.append(len(before) == len(after) and all(
                torch.equal(a, b) for a, b in zip(before, after)))
            return rep
    for tag, argv in (("replan", ["--steps", "24", "--shift-at", "6", "--replan",
                                  "--trace", trace_path, "--ckpt", ckpt_path]),
                      ("compose", ["--steps", "12", "--compose-window", "2"]),
                      ("random", ["--steps", "12", "--random"])):
        reset_counts()
        torch.cuda.synchronize()
        log(f"[runtime] {tag}: python -m repro_torch.train_mllm {' '.join(argv)}")
        CheckedSwapper.same = []
        run = m100_loop.run(m100_loop.parse_args(argv + ["--device", "cuda"]),
                            swapper_cls=CheckedSwapper)
        ctl, steps = run["ctl"], run["steps"]
        for st in steps:
            sc = st["schedule"]
            log(f"[runtime] {tag} step {st['step']}: loss {st['loss']:.5f}, "
                f"{st['seconds']:.4f} s, cmax {sc.cmax:.6f} s, predicted step "
                f"{sc.step_makespan:.6f} s (measured / predicted "
                f"{st['seconds'] / sc.step_makespan:.2f}), solver {sc.solver}, groups "
                f"{[len(g) for g in sc.groups]}, plan {sc.plan.as_tuple()}, "
                f"search in flight {st['in_flight']}")
        losses = [st["loss"] for st in steps]
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"runtime {tag}: non-finite loss {losses}")
        secs = [st["seconds"] for st in steps[1:]]
        busy = [st["seconds"] for st in steps[1:] if st["in_flight"]]
        quiet = [st["seconds"] for st in steps[1:] if not st["in_flight"]]
        log(f"[runtime] {tag}: {len(steps)} steps in {run['wall_s']:.2f} s; steps 1.. "
            f"mean {sum(secs) / len(secs):.4f} s, min {min(secs):.4f}, max {max(secs):.4f}; "
            f"with a re-plan search in flight {len(busy)} steps"
            + (f", mean {sum(busy) / len(busy):.4f} s" if busy else "")
            + (f"; without, mean {sum(quiet) / len(quiet):.4f} s" if quiet else "")
            + f"; peak {run['peak_gib']:.3f} GiB")
        kinds = {}
        for ev in ctl.drift.events:
            kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
        log(f"[runtime] {tag}: drift events {kinds}: " + "; ".join(
            f"{ev.kind} statistic {ev.statistic:.4f} (threshold {ev.threshold}) at item "
            f"{ev.n_obs}" for ev in ctl.drift.events))
        spans = [e["dur"] / 1e6 for e in ctl.trace.to_chrome()["traceEvents"]
                 if e["name"] == "replan-search"]
        for r in ctl.replans:
            log(f"[runtime] {tag}: replan on {r.trigger.kind}: stale makespan "
                f"{r.stale_makespan:.6f} s, new {r.new_makespan:.6f} s, swapped {r.swapped}"
                f", gated {r.gated}, plan {r.plan_tuple}, search host {r.search_elapsed_s:.3f}"
                f" s")
        log(f"[runtime] {tag}: replan-search spans (host s): "
            f"{[round(x, 4) for x in spans]}; final plan {ctl.plan.as_tuple()}")
        log(f"[runtime] {tag}: metrics {json.dumps(ctl.metrics.snapshot())}")
        # the physical half of each plan swap (launch/reshard.ParamSwapper)
        snap = ctl.metrics.snapshot()
        reshards = [(e["dur"] / 1e6, e["args"]["old"], e["args"]["new"])
                    for e in ctl.trace.to_chrome()["traceEvents"] if e["name"] == "reshard"]
        log(f"[runtime] {tag}: physical_swaps {snap['n_physical_swaps']}, reshard_mean_s "
            f"{snap['reshard_mean_s']}, replans adopted {snap['n_replans']}; trace reshard "
            f"spans (host s, old plan, new plan) {reshards}; reports "
            + "; ".join(f"{r.old_plan} -> {r.new_plan}: {r.bytes_moved} of {r.bytes_total} "
                        f"bytes moved in {r.elapsed_s:.5f} s" for r in run["swapper"].reports)
            + f"; each swap left (params, opt) bitwise unchanged: {CheckedSwapper.same}; "
            f"final layout {getattr(run['state'], 'layout', 'plain (no swap)')}")
        if not (len(reshards) == snap["n_physical_swaps"] == snap["n_replans"]
                == len(CheckedSwapper.same)):
            raise SystemExit(f"runtime {tag}: {len(reshards)} reshard spans, "
                             f"{snap['n_physical_swaps']} physical swaps, "
                             f"{snap['n_replans']} adopted re-plans")
        if not all(CheckedSwapper.same):
            raise SystemExit(f"runtime {tag}: a swap changed (params, opt)")
        n = {(kn, shape): pfa.LAUNCHES[(COUNTER[kn], pfa.CUDA_CORE, path_shapes[shape]["D"],
                                        path_shapes[shape]["causal"])]
             for kn in COUNTER for shape in m100_shapes}
        log(f"[runtime] {tag}: K1-K3 launches (kernel, route, head_dim, causal): "
            f"{dict(pfa.LAUNCHES)}")
        if any(key[1] != pfa.CUDA_CORE for key in pfa.LAUNCHES) or min(n.values()) == 0:
            raise SystemExit(f"runtime {tag}: K1-K3 must all launch on the CUDA cores at "
                             f"both shapes: {dict(pfa.LAUNCHES)}")
        for key in m100_launches:
            m100_launches[key] += n[key]
        m100_steps += len(steps)
        if tag == "replan":
            if kinds.get("shape-ks", 0) < 1 or not ctl.replans:
                raise SystemExit(f"runtime replan: no shape-ks drift or no finished "
                                 f"re-plan: {kinds}, {ctl.replans}")
            with open(trace_path) as f:
                names = {e["name"] for e in json.load(f)["traceEvents"]}
            want = {"schedule", "step", "replan-search"}
            if not (want <= names and any(nm.startswith("drift:") for nm in names)):
                raise SystemExit(f"runtime replan: the trace lacks events: {sorted(names)}")
            restored = checkpoint.restore(ckpt_path, run["params"])
            same = all(torch.equal(a.view(torch.int32), b.detach().view(torch.int32))
                       for a, b in zip(tree_leaves(restored), tree_leaves(run["params"])))
            log(f"[runtime] replan: trace {trace_path} holds {sorted(names)}; checkpoint "
                f"{ckpt_path}.npz restores bitwise equal to the live params: {same}")
            if not same:
                raise SystemExit("runtime replan: the checkpoint does not restore bitwise")
        # one more step under the profiler (after the counts and the checkpoint)
        profile_step(lambda: run["train_step"](run["params"], run["opt"], run["batch"],
                                               run["lr"]),
                     f"mllm-100m {tag}", m100_shapes, sum(secs) / len(secs))
        del run, ctl
        torch.cuda.empty_cache()
    launches.update(m100_launches)
    log(f"[runtime] K1-K3 launches over the {m100_steps} steps: "
        + ", ".join(f"{kn} {shape} {n} ({n / m100_steps:g}/step)"
                    for (kn, shape), n in m100_launches.items()))

    # 12. archs: MoE and the registry's configs ------------------------- #
    def train_arch(tag, cfg, key, cut):
        """3 AdamW steps of ``cfg`` (``make_train_step(ModelConfig)``, the
        capacity MoE path at FwdCtx's capacity factor) on ``arch_batches[key]``;
        fails on a non-finite loss or MoE stat, unless K1, K2 and K3 each
        launched at ``key``'s attention shape, or if any launch left the tensor
        cores; then one more step under torch.profiler, by group.  Returns the
        launches by (kernel, shape)."""
        t0 = time.perf_counter()
        params = model.init(cfg, seed=0, device=dev)
        opt = optim.adamw_init(params)
        n_params = sum(p.numel() for p in tree_leaves(params))
        torch.cuda.synchronize()
        sh = path_shapes[key]
        n_blocks = cfg.n_layers // cfg.block_period
        moe_note = (f", {cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff} "
                    f"(FFN pattern {cfg.ffn_pattern}), active {cfg.active_param_count() / 1e9:.3f} B"
                    if cfg.n_experts else f", d_ff {cfg.d_ff} ({cfg.activation})")
        log(f"[archs] {tag}: {n_params / 1e9:.3f} B params (fp32; param_count "
            f"{cfg.param_count() / 1e9:.3f} B){moe_note}; {cfg.n_layers} layers of "
            f"d{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} over {cfg.n_kv_heads} kv, "
            f"vocab {cfg.vocab_size}; {cut}; {DEC_MB} x {sh['B']} rows x {sh['S']} "
            f"tokens a step; init {time.perf_counter() - t0:.1f} s")
        batches = [step.as_tensors(b, device=dev) for b in arch_batches[key]]
        ctx = FwdCtx()
        train_step = step.make_train_step(cfg, optim.AdamWConfig(), ctx=ctx)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        seconds = []
        for i, b in enumerate(batches):
            t0 = time.perf_counter()
            params, opt, m = train_step(params, opt, b, 3e-4)
            loss, drop, imb = (m[k].item() for k in ("loss", "moe_drop_rate", "moe_imbalance"))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            used = (b["segment_ids"] > 0).sum(-1).tolist()
            moe_stats = (f"moe_drop_rate {drop:.6f} (the reference's: the mean over MoE "
                         f"layers / n_blocks {n_blocks}; x {n_blocks} = {drop * n_blocks:.6f}), "
                         f"moe_imbalance {imb:.4f}, capacity factor {ctx.capacity_factor}; "
                         if cfg.n_experts else "")
            log(f"[archs] {tag} step {i}: loss {loss:.5f}, {seconds[-1]:.3f} s, {moe_stats}"
                f"tokens in segments per row {used}")
            if not math.isfinite(loss):
                raise SystemExit(f"archs {tag}: non-finite loss")
            if cfg.n_experts and not (math.isfinite(drop) and math.isfinite(imb)):
                raise SystemExit(f"archs {tag}: non-finite MoE stats {drop}, {imb}")
        counts = {(kn, key): pfa.LAUNCHES[(COUNTER[kn], pfa.route_of(torch.bfloat16),
                                           sh["D"], sh["causal"])] for kn in COUNTER}
        peak = torch.cuda.max_memory_allocated()
        n = [counts[(kn, key)] for kn in COUNTER]
        log(f"[archs] {tag} launches over 3 steps (D {sh['D']}, causal {sh['causal']}, window "
            f"{sh.get('window', 0)}): K1 {n[0]}, K2 {n[1]}, K3 {n[2]} (per step {n[0] / 3:g}/"
            f"{n[1] / 3:g}/{n[2] / 3:g}); all: {dict(pfa.LAUNCHES)}; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB")
        if min(n) == 0:
            raise SystemExit(f"archs {tag}: a kernel was not launched on the main path: {counts}")
        check_routes(f"archs {tag}")
        if peak >= 80e9:
            raise SystemExit(f"archs {tag}: peak {peak / 1e9:.1f} GB is not under 80 GB")
        profile_step(lambda: train_step(params, opt, batches[0], 3e-4), tag, (key,),
                     sum(seconds[1:]) / len(seconds[1:]), model_cfg=cfg)
        del params, opt, batches, train_step
        torch.cuda.empty_cache()
        return counts

    # (a) Granite-MoE-3B-A800M, full size; (b) Mixtral-8x7B, full width, 2 of
    # 32 layers
    launches.update(train_arch("granite-moe-3b-a800m", granite_cfg, "granite",
                               "full size"))
    launches.update(train_arch("mixtral-8x7b", mixtral_cfg, "mixtral",
                               f"full width, cut from {mixtral_full.n_layers} to "
                               f"{mixtral_cfg.n_layers} layers"))

    # (c) the capacity path against the dense oracle, one MoE layer of each at
    # full width: nothing drops at capacity_factor = E / k; held to phase 6's
    # path tolerances (loss 2e-4, ||g_capacity - g_dense|| / ||g_dense|| 5e-2
    # over the gradients of x, the router and the experts), the output to the
    # bf16 kernel pair (TOL); the capacity path run twice must be bitwise equal
    for tag, cfg in (("granite-moe-3b-a800m", granite_cfg), ("mixtral-8x7b", mixtral_cfg)):
        T = 8192
        gen1 = torch.Generator(device=dev).manual_seed(5)
        p1 = {k: v.requires_grad_(True) for k, v in moe.init(gen1, cfg).items()}
        x = torch.randn(1, T, cfg.d_model, generator=gen1, device=dev).to(torch.bfloat16)
        cf = cfg.n_experts / cfg.top_k

        def run(impl):
            xg = x.clone().requires_grad_(True)
            for v in p1.values():
                v.grad = None
            t0 = time.perf_counter()
            y, lb, st = moe.apply(p1, xg, cfg, impl=impl, capacity_factor=cf, with_stats=True)
            # a loss that is not near zero: mean of y^2 (its gradient 2y/N)
            loss = 0.5 * y.float().square().mean() + step.LB_LOSS_WEIGHT * lb
            loss.backward()
            torch.cuda.synchronize()
            return dict(loss=loss.detach(), y=y.detach(), drop=st["drop_rate"].item(),
                        grads=[xg.grad] + [p1[k].grad.clone() for k in sorted(p1)],
                        s=time.perf_counter() - t0)

        first, second, dense = run("capacity"), run("capacity"), run("dense")
        names = ["x"] + sorted(p1)
        same = torch.equal(first["y"], second["y"]) and torch.equal(
            first["loss"], second["loss"]) and all(
            torch.equal(a, b) for a, b in zip(first["grads"], second["grads"]))
        rel_loss = abs(first["loss"].item() - dense["loss"].item()) / abs(dense["loss"].item())
        gaps = [(a.float() - b.float()).norm().item() for a, b in
                zip(first["grads"], dense["grads"])]
        norm = math.sqrt(sum(b.float().norm().item() ** 2 for b in dense["grads"]))
        rel_g = math.sqrt(sum(g * g for g in gaps)) / norm
        log(f"[archs] oracle {tag}, 1 MoE layer, T {T}, capacity factor {cf:g} (drop "
            f"{first['drop']}): loss capacity {first['loss'].item():.6f} vs dense "
            f"{dense['loss'].item():.6f}, relative {rel_loss:.3e} (tol {PATH_TOL['loss']:.0e}); "
            f"||g_capacity - g_dense|| / ||g_dense|| {rel_g:.3e} (tol {PATH_TOL['grads']:.0e}; "
            f"by leaf " + ", ".join(f"{nm} {g / max(b.float().norm().item(), 1e-30):.2e}"
                                    for nm, g, b in zip(names, gaps, dense["grads"]))
            + f"); capacity run twice bitwise equal: {same}; fwd+bwd {first['s']:.3f} s "
            f"capacity, {dense['s']:.3f} s dense")
        check_pair(f"archs oracle {tag} y (capacity vs dense)",
                   rel_errors(("y",), (first["y"],), (dense["y"],)), torch.bfloat16)
        if first["drop"] != 0.0 or not (rel_loss <= PATH_TOL["loss"]
                                        and rel_g <= PATH_TOL["grads"]):
            raise SystemExit(f"archs oracle {tag}: the capacity path disagrees with the "
                             f"dense oracle")
        if not same:
            raise SystemExit(f"archs oracle {tag}: the capacity path is not bitwise "
                             f"repeatable")
        del p1, x, first, second, dense
        torch.cuda.empty_cache()

    # (d) HuBERT-XLarge, full size, the encoder-only loss; (e) gemma-2b, full size
    launches.update(train_arch("hubert-xlarge", hubert_cfg, "hubert", "full size"))
    launches.update(train_arch("gemma-2b", gemma_cfg, "gemma", "full size"))

    # 13. serve ------------------------------------------------------------ #
    phase_serve(dev, timing, launches, max_err)

    # 14. dist ------------------------------------------------------------- #
    phase_dist(dev, timing, launches, max_err, q_batch0,
               mllm_batch(MixedDataset("mixed", seed=0, tokens_per_media_item=1024),
                          internvl2_2b.CFG, MAX_MEDIA, MAX_TEXT, 0), check_routes)

    # 15. elastic ---------------------------------------------------------- #
    phase_elastic(dev, timing, launches, max_err, q_batch0, check_routes)

    # 16. shard ------------------------------------------------------------ #
    phase_shard(dev, timing, launches, max_err,
                {k: v[0] for k, v in arch_batches["mixtral"][0].items()})

    # 17. drivers ---------------------------------------------------------- #
    phase_drivers(dev)

    # 18. dryrun ----------------------------------------------------------- #
    phase_dryrun(dev, gemma_cfg, arch_batches["gemma"][0])

    # 19. summary ---------------------------------------------------------- #
    kernels = []
    for (kn, shape), r in timing.items():
        kernels.append({
            "name": f"{kn}_{SCAN_NAME.get(kn) or COUNTER[kn]}[{shape}]", "route": "cuda",
            "source": CSRC + SOURCE[kn], "replaces": REPLACES[kn],
            "launches": launches[(kn, shape)], "max_abs_err": max_err[(kn, shape)], **r})
    log(f"[summary] wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
