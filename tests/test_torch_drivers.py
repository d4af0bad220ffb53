"""The port's last three drivers (``python -m repro_torch.{plan_inspector,
serve_decode,serve_mllm}``) in-process on the CPU, against the reference.

* ``plan_inspector.run`` priced at the reference's v5e (16 chips a node
  injected) gives the reference ``DFLOPEngine``'s θ*, makespan and uniform
  baselines on the same arguments (internvl2-2b, 16 chips, gbs 32), equal.
* ``serve_decode.run`` on the reference's weights and prompts gives the
  reference ``greedy_generate``'s tokens for each tiny family, equal.
* ``serve_mllm.run`` (priced at v5e): its continuous-batching tokens equal
  each request's solo greedy run; its emulated reports equal the reference
  ``engine.serving().run`` on the same requests; its real-backend part
  completes every request.  No test reads a time, and the reference's
  ``RealBackend`` never runs.
"""
import argparse
import json

import jax
import numpy as np
import pytest
import torch

from repro_torch.common.types import PORT_ONLY_FIELDS
from repro_torch.convert import params_from_jax
from repro_torch.core.profiling.analytic import V5E

torch.set_num_threads(1)


def _args(**kw):
    return argparse.Namespace(device="cpu", **kw)


def test_plan_inspector_equals_reference_engine(capsys):
    from repro.configs import get_config as jget_config
    from repro.core.engine import DFLOPEngine as JEngine
    from repro.core.optimizer.objective import MeanObjective as JMean
    from repro.core.optimizer.space import ClusterSpec as JClusterSpec
    from repro.core.profiling.analytic import V5E as JV5E
    from repro.core.profiling.analytic import AnalyticBackend as JBackend
    from repro.data.synthetic import MixedDataset as JMixed
    from repro_torch import plan_inspector

    args = _args(arch="internvl2-2b", chips=16, gbs=32, objective="mean", seed=0)
    got = plan_inspector.run(args, hardware=V5E, chips_per_node=16)
    printed = capsys.readouterr().out
    assert "[theta*] encoder (tp=" in printed and "[baselines]" in printed

    spec = jget_config(args.arch)
    tpm = spec.tokens_per_media_item or 196
    eng = JEngine(llm_cfg=spec.llm_cfg, enc_cfg=spec.desc.encoder,
                  e_seq_len=spec.desc.stub.n_tokens,
                  cluster=JClusterSpec(n_chips=16, chips_per_node=16),
                  tokens_per_media_item=tpm, backend=JBackend(JV5E))
    eng.profile(JMixed("mixed", seed=0, tokens_per_media_item=tpm))
    assert (got["mean_batch"], got["mean_seq"]) == tuple(eng.dist.mean())
    assert got["cv"] == eng.dist.heterogeneity()
    eng.objective = args.objective
    res = eng.plan(args.gbs, seed=args.seed)
    assert got["result"].plan.as_tuple() == res.plan.as_tuple()
    assert got["result"].makespan == res.makespan
    assert (got["result"].n_configs, got["result"].n_feasible) == (res.n_configs,
                                                                   res.n_feasible)
    assert got["ref"] == JMean().evaluate(eng.perf, res.plan, eng.dist, args.gbs)
    want = {}
    for tp in (1, 2, 4, 8, 16):
        for pp in (1, 2, 4):
            b = eng.baseline_plan(args.gbs, tp=tp, pp=pp)
            if b.found and b.makespan != float("inf"):
                want[(tp, pp)] = b.makespan
    assert got["baselines"] == want and len(want) > 1


def test_serve_decode_tokens_equal_reference(capsys):
    from repro.common.types import ModelConfig as JModelConfig
    from repro.models import model as jmodel
    from repro.serve.steps import greedy_generate as jgreedy
    from repro_torch import serve_decode

    params, prompts, want = {}, {}, {}
    for cfg in serve_decode.CONFIGS:
        jcfg = JModelConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__
                               if f not in PORT_ONLY_FIELDS})
        jp = jmodel.init(jax.random.PRNGKey(0), jcfg)
        prompt = jax.random.randint(jax.random.PRNGKey(1),
                                    (serve_decode.B, serve_decode.PROMPT_LEN), 2,
                                    cfg.vocab_size)
        want[cfg.name] = np.asarray(jgreedy(
            jcfg, jp, prompt, max_new=serve_decode.MAX_NEW,
            max_len=serve_decode.PROMPT_LEN + serve_decode.MAX_NEW))
        params[cfg.name] = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
        prompts[cfg.name] = np.array(prompt)
    got = serve_decode.run(_args(), params=params, prompts=prompts)
    printed = capsys.readouterr().out
    for cfg in serve_decode.CONFIGS:
        assert f"{cfg.name}" in printed
        np.testing.assert_array_equal(got[cfg.name]["tokens"].numpy(), want[cfg.name])
    assert printed.count(" generated ") == len(serve_decode.CONFIGS)


@pytest.fixture(scope="module")
def serve_mllm_run():
    from repro_torch import serve_mllm
    return serve_mllm.run(_args(), hardware=V5E)


def test_serve_mllm_continuous_batching_equals_solo_greedy(serve_mllm_run):
    from repro_torch import serve_mllm
    from repro_torch.models import model
    from repro_torch.serve.steps import greedy_generate

    part = serve_mllm_run["batching"]
    params = model.init(serve_mllm.TINY, seed=0, device="cpu")    # run()'s seeded init
    lens = {0: 6, 1: 12, 2: 6}
    for i, prompt in enumerate(part["prompts"]):
        assert len(part["tokens"][i]) == lens[i]
        solo = greedy_generate(serve_mllm.TINY, params, prompt[None], max_new=lens[i],
                               max_len=32)
        assert solo[0, len(prompt):].tolist() == part["tokens"][i], i


def test_serve_mllm_emulated_equals_reference(serve_mllm_run):
    from benchmarks.common import DEFAULT_CLUSTER, engine_for
    from benchmarks.fig19_serving import bursty_requests
    from repro.serve import PrefillPricer, ServeConfig

    eng = engine_for("llava-ov-llama8b", DEFAULT_CLUSTER, mixture="mixed", seed=0)
    cfg = ServeConfig(n_prefill_workers=2, n_decode_workers=2, decode_slots=8,
                      max_prefill_batch=8)
    slo_pricer = PrefillPricer(eng.perf, eng.tokens_per_media_item)
    got = serve_mllm_run["emulated"]
    assert sorted(got) == ["fifo", "slo"]
    for policy in ("fifo", "slo"):
        reqs = bursty_requests(160, qps=4.0, tpm=eng.tokens_per_media_item,
                               pricer=slo_pricer, seed=0)
        want = eng.serving(admission=policy, serve_cfg=cfg).run(reqs)
        assert json.dumps(got[policy].row(), sort_keys=True) == json.dumps(
            want.row(), sort_keys=True), policy
        assert got[policy].n_requests == 160


def test_serve_mllm_real_backend_completes(serve_mllm_run):
    part = serve_mllm_run["real"]
    rep = part["report"]
    assert rep.n_completed == rep.n_requests == 8
    assert all(len(r.generated) == r.max_new_tokens for r in part["requests"])
    assert {m for (m, _, _) in part["serve"].calibrator.cells} == {"decode", "prefill"}


@pytest.mark.parametrize("module", ["plan_inspector", "serve_decode", "serve_mllm"])
def test_drivers_default_to_the_card(module):
    import importlib

    mod = importlib.import_module(f"repro_torch.{module}")
    assert mod.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mod.run(mod.parse_args(["--chips", "16"] if module == "plan_inspector" else []))
