"""The serving loop against the reference, on the CPU: the emulated engine
on fig19's smoke stream (byte-equal to the reference's golden), the
admission pricer, the torch ``RealBackend`` (every request's tokens equal
the reference's solo generation, through a park and re-join too) and
``DFLOPEngine.serving()``'s wiring.

The serving loop's numpy code is a copy of the reference's, so its results
must be *equal*.  The real backend runs a tiny fp32 model whose weights come
from the reference (``params_from_jax``); the reference's solo generations
use its ``prefill_into_cache`` and ``make_decode_step``, never its
``RealBackend``.  The real backend measures durations on the host clock and
the loop replays them, so which requests share a batch may vary from run to
run: the tests hold tokens, completions and wiring, never a time.
"""
import dataclasses
import doctest
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.fig19_serving import bursty_requests
from repro.common.types import ModelConfig as JModelConfig
from repro.core.engine import DFLOPEngine as JEngine
from repro.core.optimizer.space import ClusterSpec as JClusterSpec
from repro.data.items import DataItem as JDataItem
from repro.data.synthetic import MixedDataset as JMixedDataset
from repro.models import model as jmodel
from repro.runtime import OnlineCalibrator as JOnlineCalibrator
from repro.serve import PrefillPricer as JPrefillPricer
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import make_decode_step as jmake_decode_step
from repro.serve import prefill_into_cache as jprefill_into_cache
from repro_torch.common.types import ModelConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.space import ClusterSpec
from repro_torch.core.profiling.analytic import V5E, AnalyticBackend
from repro_torch.data.items import DataItem
from repro_torch.data.synthetic import MixedDataset
from repro_torch.runtime import OnlineCalibrator
from repro_torch.runtime.drift import PageHinkley
from repro_torch.runtime.metrics import nan_to_none
from repro_torch.serve import (EmulatedBackend, FIFOAdmission, PrefillPricer,
                               RealBackend, Request, ServeConfig, SLOAdmission)
from repro_torch.serve.real import serve_device_pools

# tiny shapes: one thread each keeps xdist workers from oversubscribing
# the cores that wall-clock-sensitive tests in other workers share
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "fig19_prerefactor.json")

TPM = 8
MAX_LEN = 64
TINY = dict(enc=dict(name="tb-enc", family="vlm-enc", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=0,
                     causal=False, use_rope=False, input_embed_dim=32,
                     has_lm_head=False),
            llm=dict(name="tb-llm", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=128,
                     dtype="float32"))
CLUSTER = dict(n_chips=4, chips_per_node=4, mem_bytes=16e9)
CPU = [torch.device("cpu")]


def _engines():
    """The tiny engine of ``tests/test_serve_backend.py`` in both packages,
    profiled on the same data and priced with the reference's default
    hardware (the port's default is the H100)."""
    eng = DFLOPEngine(llm_cfg=ModelConfig(**TINY["llm"]),
                      enc_cfg=ModelConfig(**TINY["enc"]), e_seq_len=16,
                      cluster=ClusterSpec(**CLUSTER), tokens_per_media_item=TPM,
                      backend=AnalyticBackend(V5E))
    jeng = JEngine(llm_cfg=JModelConfig(**TINY["llm"]),
                   enc_cfg=JModelConfig(**TINY["enc"]), e_seq_len=16,
                   cluster=JClusterSpec(**CLUSTER), tokens_per_media_item=TPM)
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=TPM), n_samples=64)
    jeng.profile(JMixedDataset("mixed", seed=0, tokens_per_media_item=TPM),
                 n_samples=64)
    return eng, jeng


@pytest.fixture(scope="module")
def engines():
    return _engines()


@pytest.fixture(scope="module")
def tiny():
    """The tiny LLM's reference params and the port's copy on the CPU."""
    jparams = jmodel.init(jax.random.PRNGKey(0), JModelConfig(**TINY["llm"]))
    params = params_from_jax(jax.tree.map(np.asarray, jparams),
                             ModelConfig(**TINY["llm"]), device="cpu")
    return jparams, params


def _req(i, *, arrival=0.0, slo=60.0, n_media=1, text=16, max_new=6):
    return Request(item=DataItem(n_media, text, "single_image", i),
                   arrival_s=arrival, slo_s=slo, max_new_tokens=max_new)


def _jreq(r):
    return JRequest(item=JDataItem(r.item.n_media_items, r.item.text_len,
                                   r.item.modality, r.item.item_id),
                    arrival_s=r.arrival_s, slo_s=r.slo_s,
                    max_new_tokens=r.max_new_tokens, true_factor=r.true_factor)


_SOLO = jax.jit(jmake_decode_step(JModelConfig(**TINY["llm"])))


def _reference_solo(jparams, prompt_1d, max_new):
    """The reference's generation of one request that never leaves its own
    B=1 cache: ``prefill_into_cache``, then greedy decode steps."""
    cfg = JModelConfig(**TINY["llm"])
    prompt = jnp.asarray(np.asarray(prompt_1d)[None, :], jnp.int32)
    logits, caches = jprefill_into_cache(cfg, jparams, prompt, MAX_LEN)
    toks, pos = [], prompt.shape[1]
    tok = jnp.argmax(logits, axis=-1).reshape(1).astype(jnp.int32)
    for _ in range(max_new):
        toks.append(int(tok[0]))
        logits, caches = _SOLO(jparams, caches, tok, pos)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        pos += 1
    return toks


# --------------------------------------------------------------------------- #
# The emulated loop and the pricer
# --------------------------------------------------------------------------- #
def test_emulated_stream_identical_to_fig19_golden():
    """fig19's smoke point (``benchmarks.fig19_serving.run_smoke``) through
    the port: LLaVA-OV-Llama3-8B profiled on the mixed data at the
    benchmarks' default cluster, the stream from fig19's generator (fed the
    port's pricer), both policies; the rows byte-equal (sorted-key JSON) to
    the reference's golden."""
    spec = get_config("llava-ov-llama8b")
    tpm = spec.tokens_per_media_item or 196
    eng = DFLOPEngine(llm_cfg=spec.llm_cfg, enc_cfg=spec.desc.encoder,
                      e_seq_len=spec.desc.stub.n_tokens,
                      cluster=ClusterSpec(n_chips=32, chips_per_node=8,
                                          mem_bytes=80e9, name="4-node 8xA100-like"),
                      tokens_per_media_item=tpm, backend=AnalyticBackend(V5E))
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=tpm), n_samples=1024)
    cfg = ServeConfig(n_prefill_workers=1, n_decode_workers=1, decode_slots=4,
                      max_prefill_batch=4)
    slo_pricer = PrefillPricer(eng.perf, tpm, tp=cfg.tp)
    qps, rows, reports = 2.0, [], {}
    for policy in ("fifo", "slo"):
        serve = eng.serving(admission=policy, serve_cfg=cfg)
        stream = bursty_requests(48, qps, tpm=tpm, pricer=slo_pricer, seed=0)
        reqs = [Request(item=DataItem(r.item.n_media_items, r.item.text_len,
                                      r.item.modality, r.item.item_id),
                        arrival_s=r.arrival_s, slo_s=r.slo_s,
                        max_new_tokens=r.max_new_tokens, true_factor=r.true_factor)
                for r in stream]
        reports[policy] = rep = serve.run(reqs)
        rows.append({"figure": "fig19", "qps": qps, **rep.row()})
    f, s = reports["fifo"], reports["slo"]
    rows.append({"figure": "fig19", "qps": qps, "summary": True,
                 "goodput_ratio": s.goodput_rps / max(f.goodput_rps, 1e-12),
                 "p99_fifo_s": nan_to_none(f.p99_latency_s),
                 "p99_slo_s": nan_to_none(s.p99_latency_s),
                 "slo_met_fifo": f.n_slo_met, "slo_met_slo": s.n_slo_met})
    with open(GOLDEN) as fh:
        want = json.load(fh)["smoke"]
    assert json.dumps(rows, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_prefill_pricer_prices_and_decode_fits_equal_reference(engines):
    """Prices, padded predictions and decode token costs, before and after a
    calibrator learns (and a flush re-prices), equal the reference's."""
    eng, jeng = engines
    cal, jcal = OnlineCalibrator(), JOnlineCalibrator()
    pricer = PrefillPricer(eng.perf, TPM, calibrator=cal)
    jpricer = JPrefillPricer(jeng.perf, TPM, calibrator=jcal)
    rng = np.random.default_rng(5)
    reqs = [_req(i, n_media=int(rng.integers(1, 6)), text=int(rng.integers(4, 300)))
            for i in range(12)]

    def snapshot(p, rs):
        out = []
        for r in rs:
            out += [p.shapes(r), p.base(r), p.price(r), p.predict(r, 1024),
                    p.pad_extra(r, 2048), p.decode_estimate(r)]
        return out + [p.decode_tok_base_s(c) for c in (64, 300, 4096)] + \
            [p.decode_tok_s(c) for c in (64, 300, 4096)]

    jreqs = [_jreq(r) for r in reqs]
    assert snapshot(pricer, reqs) == snapshot(jpricer, jreqs)
    for p, c, rs in ((pricer, cal, reqs), (jpricer, jcal, jreqs)):
        for r in rs[:6]:
            base, _, s = p.base(r)
            c.observe("prefill", s, 1, base, base * 1.7)
        for _ in range(4):
            c.observe("decode", 256.0, 1, 1.0, 2.5)
        p.flush()
    assert snapshot(pricer, reqs) == snapshot(jpricer, jreqs)
    assert pricer.n_flushes == jpricer.n_flushes == 1


def test_serve_device_pools_contract():
    a, b, c = (torch.device("cpu"),) * 3
    assert serve_device_pools(1, 1, [a]) == ([a], [a])
    assert serve_device_pools(2, 1, [a, b, c]) == ([a, b], [c])
    with pytest.raises(ValueError):
        serve_device_pools(0, 1, [a])


@pytest.mark.parametrize("module", ["repro_torch.serve.request",
                                    "repro_torch.serve.admission",
                                    "repro_torch.serve.engine",
                                    "repro_torch.serve.backend"])
def test_serve_doctests(module):
    res = doctest.testmod(importlib.import_module(module))
    assert res.failed == 0


# --------------------------------------------------------------------------- #
# The real backend
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("admission", ["slo", "fifo"])
def test_real_backend_tokens_equal_reference_solo(engines, tiny, admission):
    """The whole loop (admission, chunked prefill, handoff, continuous-batch
    decode with join/leave/compaction) serves a tiny stream: every request
    completes and generates exactly the reference's solo sequence."""
    eng, _ = engines
    jparams, params = tiny
    cfg = ServeConfig(n_prefill_workers=1, n_decode_workers=1, decode_slots=2,
                      max_prefill_batch=2)
    serve = eng.serving(admission=admission, serve_cfg=cfg, backend="real",
                        model_params=params, max_len=MAX_LEN, chunk=16,
                        devices=CPU, warmup=False)
    rng = np.random.default_rng(3)
    reqs = [_req(i, arrival=float(i) * 1e-3, n_media=int(rng.integers(1, 4)),
                 text=int(rng.integers(4, 20)), max_new=5) for i in range(6)]
    rep = serve.run(reqs)
    assert rep.n_completed == 6
    assert serve.metrics.n_prefill_chunks > 0
    assert {m for m, _, _ in serve.prediction_log} == {"prefill", "decode"}
    for r in reqs:
        want = _reference_solo(jparams, serve.backend.prompt_for(r), 5)
        assert r.generated == want, r.item.item_id


def test_real_backend_park_rejoin_preserves_generation(engines, tiny):
    """Park a mid-decode row (snapshot before compaction), decode the
    survivor, re-join the parked request: both sequences equal the
    reference's solo generations."""
    eng, _ = engines
    jparams, params = tiny
    pricer = PrefillPricer(eng.perf, TPM)
    cfg = ServeConfig(n_prefill_workers=1, n_decode_workers=1, decode_slots=2,
                      max_prefill_batch=2)
    be = RealBackend(ModelConfig(**TINY["llm"]), params, pricer, cfg,
                     max_len=MAX_LEN, chunk=8, devices=CPU, warmup=False)
    ra = _req(0, n_media=2, text=10)
    rb = _req(1, n_media=1, text=5)
    solo = {0: _reference_solo(jparams, be.prompt_for(ra), 6),
            1: _reference_solo(jparams, be.prompt_for(rb), 6)}
    be.prefill(0, [ra, rb], s_pad=MAX_LEN)
    for r in (ra, rb):
        be.handoff(r)
        be.join(0, r)
    for _ in range(2):
        be.decode_step(0, [ra, rb])
    be.release(0, ra, park=True)             # preempt A mid-generation
    for _ in range(4):                       # B finishes alone
        be.decode_step(0, [rb])
    be.release(0, rb)
    be.join(0, ra)                           # A re-joins from the park
    for _ in range(4):
        be.decode_step(0, [ra])
    be.release(0, ra)
    assert ra.generated == solo[0]
    assert rb.generated == solo[1]


def test_real_backend_warmup_and_probe(engines, tiny):
    """``warmup`` records a unit cost for every chunk size and occupancy
    bucket; ``probe`` gives the calibrator prefill and decode cells and
    flushes the pricer."""
    eng, _ = engines
    _, params = tiny
    cal = OnlineCalibrator(max_ratio=1e9, min_obs=1)
    pricer = PrefillPricer(eng.perf, TPM, calibrator=cal)
    cfg = ServeConfig(n_prefill_workers=1, n_decode_workers=1, decode_slots=4)
    be = RealBackend(ModelConfig(**TINY["llm"]), params, pricer, cfg,
                     max_len=MAX_LEN, chunk=4, devices=CPU)
    assert set(be.unit_costs) == {"prefill_s_per_tok", "decode_step_s_b1",
                                  "decode_step_s_b2", "decode_step_s_b4",
                                  "decode_step_s"}
    be.probe([_req(i, n_media=1 + i % 2, text=5) for i in range(4)], n_obs=1)
    assert pricer.n_flushes == 1
    assert {k.split("/")[0] for k in cal.snapshot()} >= {"prefill", "decode"}


# --------------------------------------------------------------------------- #
# DFLOPEngine.serving()
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["emulated", "real", "factory"])
@pytest.mark.parametrize("admission", ["slo", "fifo"])
def test_serving_wires_admission_backend_and_loop(engines, tiny, admission, backend):
    """The engine's admission policy, backend, calibrator (clip and burn-in),
    Page–Hinkley and trace as the reference wires them."""
    eng, jeng = engines
    made = []

    def factory(pricer, cfg):
        made.append(EmulatedBackend(pricer, cfg))
        return made[-1]

    kw = {"real": dict(backend="real", model_params=tiny[1], devices=CPU,
                       warmup=False),
          "factory": dict(backend=factory)}.get(backend, {})
    serve = eng.serving(admission=admission, **kw)
    want_adm = FIFOAdmission if admission == "fifo" else SLOAdmission
    assert type(serve.admission) is want_adm
    if backend == "real":
        assert isinstance(serve.backend, RealBackend)
        assert (serve.calibrator.max_ratio, serve.calibrator.min_obs) == (1e9, 1)
    else:
        # the reference's wiring of the same options (no RealBackend)
        jkw = {"factory": dict(backend=lambda p, c: None)}.get(backend, {})
        jserve = jeng.serving(admission=admission, **jkw)
        assert (serve.calibrator.max_ratio, serve.calibrator.min_obs) == \
            (jserve.calibrator.max_ratio, jserve.calibrator.min_obs)
        assert serve.backend is (made[0] if made else serve.backend)
        assert isinstance(serve.backend, EmulatedBackend)
    assert serve.pricer.calibrator is serve.calibrator
    assert isinstance(serve.drift, PageHinkley)
    assert serve.trace.enabled and serve.trace.process_name == "dflop-serve"
    off = eng.serving(admission=admission, calibrate=False, drift=False,
                      trace=False, **kw)
    assert off.calibrator is None and off.drift is None and not off.trace.enabled
    ph = PageHinkley(burn_in=3)
    assert eng.serving(drift=ph).drift is ph


def test_serving_engine_results_equal_reference(engines):
    """The emulated loop on the same stream in both packages: equal reports
    and per-request timestamps under either policy."""
    eng, jeng = engines
    cfg = ServeConfig(n_prefill_workers=2, n_decode_workers=2, decode_slots=4,
                      max_prefill_batch=4, preempt_slack_s=2.0)
    jcfg = JServeConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(9)
    for admission in ("slo", "fifo"):
        reqs = [_req(i, arrival=float(i) * 0.05, slo=float(rng.uniform(0.5, 5)),
                     n_media=int(rng.integers(1, 6)), text=int(rng.integers(8, 400)),
                     max_new=int(rng.integers(2, 12))) for i in range(40)]
        jreqs = [_jreq(r) for r in reqs]
        rep = eng.serving(admission=admission, serve_cfg=cfg).run(reqs)
        jrep = jeng.serving(admission=admission, serve_cfg=jcfg).run(jreqs)
        assert json.dumps(rep.row(), sort_keys=True) == \
            json.dumps(jrep.row(), sort_keys=True)
        for r, jr in zip(reqs, jreqs):
            assert (r.admit_s, r.first_token_s, r.finish_s, r.n_preempted) == \
                (jr.admit_s, jr.first_token_s, jr.finish_s, jr.n_preempted)
