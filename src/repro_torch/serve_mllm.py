"""Serving example: data-aware admission and disaggregated continuous
batching; the port's counterpart of the reference's ``examples/serve_mllm.py``.

Three parts, mirroring the ``repro_torch.serve`` split:

  1. **Continuous batching on a real (tiny) model**: requests are prefilled
     one at a time (``prefill_into_cache``, exact length, no padding), handed
     off into a shared decode batch (``merge_cache_row``), decode rows
     advance per-request positions, and a finished row is recycled for a new
     request (``clear_cache_row``) without disturbing its neighbour.
  2. **Emulated engine** (no model, virtual time): a bursty multimodal
     request stream served under FIFO and data-aware (``SLOAdmission``)
     admission on the same emulated cluster, priced by the analytic H100
     spec: goodput, p99 and drift events per policy.
  3. **Real backend**: the same control loop drives ``RealBackend`` (chunked
     prefill, KV handoff, pow2-bucketed continuous decode) on the device,
     and every measured duration feeds the calibrator.

    PYTHONPATH=src python -m repro_torch.serve_mllm              # on the card
    PYTHONPATH=src python -m repro_torch.serve_mllm --device cpu

The request-stream generators and the engine factory are copies of the
reference's benchmark helpers (``benchmarks/fig18_composer.bursty_stream``,
``benchmarks/fig19_serving.bursty_requests``, ``benchmarks/common.engine_for``
and ``DEFAULT_CLUSTER``), priced at ``analytic.H100`` by default.
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.common.types import ModelConfig, resolve_device
from repro_torch.configs import get_config
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.space import ClusterSpec
from repro_torch.core.profiling.analytic import H100, AnalyticBackend, HardwareSpec
from repro_torch.data.items import DataItem
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import model as model_lib
from repro_torch.runtime.drift import PageHinkley
from repro_torch.serve import (PrefillPricer, Request, ServeConfig, clear_cache_row,
                               make_decode_step, merge_cache_row, prefill_into_cache)

TINY = ModelConfig(name="tiny-dense", family="dense", n_layers=2,
                   d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
                   vocab_size=128, dtype="float32")
TINY_ENC = ModelConfig(name="tiny-enc", family="vlm-enc", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                       vocab_size=0, causal=False, use_rope=False,
                       input_embed_dim=32, has_lm_head=False)
# the benchmarks' default cluster: 4 nodes of 8 cards of 80 GB
DEFAULT_CLUSTER = ClusterSpec(n_chips=32, chips_per_node=8, mem_bytes=80e9,
                              name="4-node 8xH100")
MODALITY_BIAS = {"single_image": 1.0, "multi_image": 1.1, "video": 1.3}


# --------------------------------------------------------------------------- #
# Host helpers: copies of the reference's benchmark helpers
# --------------------------------------------------------------------------- #
def engine_for(arch_id: str, cluster: ClusterSpec, mixture: str = "mixed",
               seed: int = 0, n_samples: int = 1024,
               hardware: HardwareSpec = H100) -> DFLOPEngine:
    spec = get_config(arch_id)
    ds = MixedDataset(mixture, seed=seed,
                      tokens_per_media_item=spec.tokens_per_media_item or 196)
    eng = DFLOPEngine(
        llm_cfg=spec.llm_cfg,
        enc_cfg=spec.desc.encoder if spec.is_mllm else None,
        e_seq_len=spec.desc.stub.n_tokens if spec.is_mllm else 0,
        cluster=cluster,
        tokens_per_media_item=spec.tokens_per_media_item or 196,
        backend=AnalyticBackend(hardware),
    )
    eng.profile(ds, n_samples=n_samples)
    eng.dataset = ds
    return eng


def bursty_stream(n_items: int, *, tpm: int, seed: int = 0,
                  p_stay: float = 0.8, heavy_frac: float = 0.15) -> List:
    """Sticky two-state Markov chain over item modality: runs of
    single-image items with embedded video bursts (mean burst length
    1/(1−p_stay); stationary heavy fraction ``heavy_frac``)."""
    rng = np.random.default_rng(seed)
    light = MixedDataset("single_image", seed=seed, tokens_per_media_item=tpm)
    heavy = MixedDataset("video", seed=seed + 1, tokens_per_media_item=tpm)
    p_enter = (1.0 - p_stay) * heavy_frac / (1.0 - heavy_frac)
    in_burst = False
    items = []
    for _ in range(n_items):
        r = rng.random()
        in_burst = (r < p_stay) if in_burst else (r < p_enter)
        items.append((heavy if in_burst else light).sample(1)[0])
    return items


def bursty_requests(n: int, qps: float, *, tpm: int, pricer: PrefillPricer,
                    seed: int = 0, p_stay: float = 0.6,
                    heavy_frac: float = 0.25, max_new_tokens: int = 32,
                    slo_scale: float = 6.0, slo_floor_s: float = 2.0,
                    noise_sigma: float = 0.10, drift_at: float = 0.5,
                    drift_bias: float = 1.6) -> List[Request]:
    """Open-loop request stream: Poisson arrivals at ``qps``, bursty
    modalities, per-request oracle factors (modality bias × lognormal noise;
    video slows by ``drift_bias`` after the ``drift_at`` fraction of the
    stream, the drift the engine must detect and re-price for).
    Deterministic in ``seed``: policies replay bit-identical ground truth."""
    items = bursty_stream(n, tpm=tpm, seed=seed, p_stay=p_stay,
                          heavy_frac=heavy_frac)
    rng = np.random.default_rng([seed, 19])
    arrivals = np.cumsum(rng.exponential(1.0 / qps, size=n))
    out: List[Request] = []
    for i, (it, t) in enumerate(zip(items, arrivals)):
        factor = MODALITY_BIAS.get(it.modality, 1.0) \
            * float(rng.lognormal(0.0, noise_sigma))
        if it.modality == "video" and i >= drift_at * n:
            factor *= drift_bias
        req = Request(item=it, arrival_s=float(t), slo_s=0.0,
                      max_new_tokens=max_new_tokens, true_factor=factor)
        base, _, _ = pricer.base(req)
        ideal = base + pricer.decode_estimate(req)
        req.slo_s = slo_floor_s + slo_scale * ideal
        out.append(req)
    return out


# --------------------------------------------------------------------------- #
# The three parts
# --------------------------------------------------------------------------- #
def continuous_batching(dev, max_len: int = 32, max_new: int = 6) -> dict:
    """Requests A and B prefilled alone and decoded together in a shared
    2-row cache; A leaves, its row is recycled for C, B continues (the tiny
    model seeded on ``dev``).  Returns {"prompts": [A, B, C], "tokens": {0:
    A's, 1: B's, 2: C's}}."""
    params = model_lib.init(TINY, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = [torch.randint(2, TINY.vocab_size, (n,), generator=gen, device=dev)
               for n in (5, 9, 6)]
    decode = make_decode_step(TINY)
    shared = model_lib.init_cache(TINY, 2, max_len, torch.float32, device=dev)

    # prefill A and B on the "prefill pool", hand both off
    (la, ca), (lb, cb) = (prefill_into_cache(TINY, params, p[None, :], max_len)
                          for p in prompts[:2])
    shared = merge_cache_row(shared, ca, row=0)
    shared = merge_cache_row(shared, cb, row=1)
    tok = torch.cat([la.argmax(-1), lb.argmax(-1)])
    pos = torch.tensor([len(prompts[0]), len(prompts[1])], device=dev)
    out = {0: [], 1: [], 2: []}
    for _ in range(max_new):                 # A and B decode together
        out[0].append(int(tok[0]))
        out[1].append(int(tok[1]))
        logits, shared = decode(params, shared, tok, pos)
        tok, pos = logits.argmax(-1), pos + 1
    print(f"request A done: {out[0]}")

    # step boundary: A leaves, its row is recycled for C (KV handoff)
    shared = clear_cache_row(shared, 0)
    lc, cc = prefill_into_cache(TINY, params, prompts[2][None, :], max_len)
    shared = merge_cache_row(shared, cc, row=0)
    tok = tok.clone()
    tok[0] = lc.argmax(-1)[0]
    pos = pos.clone()
    pos[0] = len(prompts[2])
    for _ in range(max_new):                 # B continues, C starts fresh
        out[2].append(int(tok[0]))
        out[1].append(int(tok[1]))
        logits, shared = decode(params, shared, tok, pos)
        tok, pos = logits.argmax(-1), pos + 1
    print(f"request B done: {out[1]}")
    print(f"request C done: {out[2]} (joined mid-flight in A's row)")
    return {"prompts": prompts, "tokens": out}


def emulated_engine(hardware: HardwareSpec = H100) -> dict:
    """FIFO against data-aware admission on the emulated cluster; returns
    {policy: ServeReport}."""
    eng = engine_for("llava-ov-llama8b", DEFAULT_CLUSTER, mixture="mixed", seed=0,
                     hardware=hardware)
    cfg = ServeConfig(n_prefill_workers=2, n_decode_workers=2, decode_slots=8,
                      max_prefill_batch=8)
    slo_pricer = PrefillPricer(eng.perf, eng.tokens_per_media_item)
    reports = {}
    for policy in ("fifo", "slo"):
        serve = eng.serving(admission=policy, serve_cfg=cfg)
        reqs = bursty_requests(160, qps=4.0, tpm=eng.tokens_per_media_item,
                               pricer=slo_pricer, seed=0)
        t0 = time.perf_counter()
        rep = reports[policy] = serve.run(reqs)
        print(f"{policy:5s}  goodput {rep.goodput_rps:6.3f} req/s  "
              f"p99 {rep.p99_latency_s:7.2f}s  "
              f"slo-met {rep.n_slo_met:3d}/{rep.n_requests}  "
              f"drift-events {rep.n_drift_events}  "
              f"compiles {rep.n_compiles}  "
              f"({time.perf_counter() - t0:.2f}s wall)")
    return reports


def real_backend(dev) -> dict:
    """The serving loop on the device through ``RealBackend`` (the tiny
    model seeded on ``dev``); returns {"report", "requests", "serve"}."""
    tpm = 8
    eng = DFLOPEngine(llm_cfg=TINY, enc_cfg=TINY_ENC, e_seq_len=16,
                      cluster=ClusterSpec(n_chips=4, chips_per_node=4, mem_bytes=16e9),
                      tokens_per_media_item=tpm)
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=tpm), n_samples=64)
    params = model_lib.init(TINY, seed=0, device=dev)
    serve = eng.serving(
        serve_cfg=ServeConfig(n_prefill_workers=1, n_decode_workers=1,
                              decode_slots=2, max_prefill_batch=2),
        backend="real", model_params=params, max_len=64, chunk=16, devices=[dev],
        drift=PageHinkley(burn_in=6, threshold=0.5))
    rng = np.random.default_rng(0)
    reqs = [Request(item=DataItem(int(rng.integers(1, 4)), int(rng.integers(8, 25)),
                                  "single_image", i),
                    arrival_s=float(i) * 1e-3, slo_s=60.0, max_new_tokens=4)
            for i in range(8)]
    serve.backend.probe(reqs)                # calibrate wall-second units
    t0 = time.perf_counter()
    rep = serve.run(reqs)
    cells = {m for (m, _, _) in serve.calibrator.cells}
    print(f"real backend ({serve.backend.name}): "
          f"{rep.n_completed}/{rep.n_requests} completed  "
          f"compiles {rep.n_compiles}  "
          f"prefill-chunks {serve.metrics.n_prefill_chunks}  "
          f"calibrated modules {sorted(cells)}  "
          f"({time.perf_counter() - t0:.2f}s wall)")
    print(f"first request generated tokens: {reqs[0].generated}")
    return {"report": rep, "requests": reqs, "serve": serve}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args, *, hardware: HardwareSpec = H100) -> dict:
    """The three parts on ``args.device`` (the emulated part priced by
    ``hardware``); returns {"batching", "emulated", "real"}, each part's
    result."""
    dev = resolve_device(args.device)
    print("== continuous batching on a real (tiny) model ==")
    batching = continuous_batching(dev)
    print("\n== emulated cluster: FIFO vs data-aware admission ==")
    emulated = emulated_engine(hardware)
    print("\n== real backend: the measured serving loop ==")
    real = real_backend(dev)
    return {"batching": batching, "emulated": emulated, "real": real}


def main(argv=None) -> int:
    out = run(parse_args(argv))
    rep = out["real"]["report"]
    if rep.n_completed != rep.n_requests:
        raise SystemExit(f"real backend completed {rep.n_completed} of {rep.n_requests}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
