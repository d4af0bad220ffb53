"""Jamba on packed rows, on the CPU at a small size: Mamba layers that
restart at every segment start, Jamba's dt/B/C norms, and the benchmark's
plain reference (``portbench/references/jamba.py``) and readers.

- ``start_words`` packs a row's segment starts into the kernels' 32-bit
  words and back.
- K4/K5's plain versions with restart words, padded to a chunk multiple as
  the entry point pads them, against the naive scan of each segment alone.
- One Mamba layer (naive, chunked and kernel scans) on a packed row gives
  each segment what it gives alone, and the same gradients.
- A tiny Jamba through the port (each scan) against the reference on rows
  of 3 segments and padding: logits, loss, every gradient, two AdamW steps.
- MQA at G 20 through K1-K3's plain path against the reference's attention.
- The ``mfu`` FLOP count of Jamba2-3B against a count by hand; the new
  readers and ``scan_bounds``; the ``mamba.segment_starts`` counter and the
  ``layer.mamba`` spans of a train step.

fp32 throughout.  Tolerances: 1e-5 (relative to the largest value) for a
layer, 1e-4 for the stack (the reference scans in closed-form blocks, the
port step by step), 5e-3 on each leaf's change after two AdamW steps (Adam
divides by the root of the second moment: an element of a tiny gradient
moves a whole step on a rounding difference; the worst leaf, the MQA layer's
wk, reads 1.8e-3).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import core, formulas, hybrid
from portbench.metrics import mamba_ms, scan_ms, scan_roofline
from portbench.scan_bounds import design_bytes, scan_bounds
from repro_torch.common import trace
from repro_torch.common.pytree import tree_paths
from repro_torch.kernels import mamba_scan
from repro_torch.kernels import ops as kops
from repro_torch.models import model
from repro_torch.models.layers import mamba
from repro_torch.models.model import FwdCtx
from repro_torch.train import optim, step

torch.set_num_threads(1)

REF = core.load_module("references", "jamba")
ROOT = Path(__file__).resolve().parents[1]
TINY = {"name": "jamba-tiny", "hidden_size": 64, "intermediate_size": 96,
        "num_attention_heads": 4, "num_key_value_heads": 1, "num_hidden_layers": 4,
        "attn_layer_period": 2, "attn_layer_offset": 1, "vocab_size": 96,
        "torch_dtype": "float32"}
SEGS = np.array([[1] * 10 + [2] * 13 + [3] * 17 + [0] * 8,
                 [1] * 3 + [2] * 30 + [3] * 11 + [0] * 4], np.int32)
S = SEGS.shape[1]
OPT = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0}


def _cfg(**kw):
    cfg = json.loads((ROOT / "portbench/configs/jamba2-3b.json").read_text())
    return {**cfg, **TINY, **kw}


def _bounds(row):
    return REF.segment_bounds(row)


def _close(got, want, tol):
    got, want = got.detach().float(), want.detach().float()
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= tol * scale, (
        float((got - want).abs().max()), scale)


# --------------------------------------------------------------------------- #
# The scans
# --------------------------------------------------------------------------- #
def test_start_words_round_trip():
    starts = mamba.segment_starts(torch.as_tensor(SEGS))
    assert starts.sum() == 6 and not starts[:, 0].any()
    words = mamba_scan.start_words(starts)
    assert words.dtype == torch.int32 and words.shape == (2, 2)
    assert torch.equal(mamba_scan.start_mask(words, S), starts)
    # every step of 32 a start: the word's sign bit set
    every = torch.ones((1, 64), dtype=torch.bool)
    assert torch.equal(mamba_scan.start_mask(mamba_scan.start_words(every), 64), every)
    assert torch.equal(mamba_scan.start_mask(words, S + 20)[:, S:],
                       torch.zeros((2, 20), dtype=torch.bool))


def _scan_inputs(seed=0, di=8, N=16):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
    u, Bt, Ct = r(2, S, di), r(2, S, N), r(2, S, N)
    dt = torch.nn.functional.softplus(r(2, S, di) - 1.0)
    A = -torch.exp(r(di, N) * 0.5)
    return u, dt, Bt, Ct, A, r(di)


def _alone(fn, *seq):
    """``fn`` on each segment of each row alone, stitched back."""
    out = torch.zeros_like(seq[0])
    for b in range(seq[0].shape[0]):
        for a, e in _bounds(SEGS[b]):
            out[b, a:e] = fn(*(t[b:b + 1, a:e] for t in seq))[0]
    return out


@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_plain_k4_k5_restart_like_each_segment_alone(chunk):
    u, dt, Bt, Ct, A, D = _scan_inputs()
    starts = mamba.segment_starts(torch.as_tensor(SEGS))
    words = mamba_scan.start_words(starts)
    w = torch.randn(u.shape, generator=torch.Generator().manual_seed(3))
    xs = [t.clone().requires_grad_(True) for t in (u, dt, Bt, Ct, A, D)]
    y = mamba_scan.mamba_scan_bsd(*xs, chunk=chunk, starts=words)
    (y * w).sum().backward()
    # the sequential scan of each segment alone
    ys = [t.clone().requires_grad_(True) for t in (u, dt, Bt, Ct, A, D)]
    want = _alone(lambda *s: mamba.ssm_scan_xla(*s, ys[4], ys[5])[0], *ys[:4])
    (want * w).sum().backward()
    _close(y, want, 1e-5)
    for got, ref in zip(xs, ys):
        _close(got.grad, ref.grad, 1e-5)


def test_plain_k4_states_are_pre_restart_and_k5_takes_them():
    """h_init is each chunk's pre-state, before its first step's restart
    (K5 replays the restart from it), so a chunk that starts a segment
    saves the previous segment's last state."""
    u, dt, Bt, Ct, A, D = _scan_inputs()
    starts = mamba.segment_starts(torch.as_tensor(SEGS))
    _, h = mamba_scan.fwd_plain(u, dt, Bt, Ct, A, D, 1, mamba_scan.start_words(starts))
    _, free = mamba.ssm_scan_xla(u[:1, :10], dt[:1, :10], Bt[:1, :10], Ct[:1, :10], A, D)
    _close(h[0, 10], free[0], 1e-6)           # step 10 starts segment 2 of row 0


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_scans_restart_at_segment_starts(impl):
    u, dt, Bt, Ct, A, D = _scan_inputs(seed=1)
    starts = mamba.segment_starts(torch.as_tensor(SEGS))
    scan = {"naive": lambda *a: mamba.ssm_scan_xla(*a, starts=starts)[0],
            "chunked": lambda *a: mamba.ssm_scan_chunked(*a, chunk=7, starts=starts)[0],
            "kernel": lambda *a: kops.mamba_scan(*a, starts=starts)[0]}[impl]
    want = _alone(lambda *s: mamba.ssm_scan_xla(*s, A, D)[0], u, dt, Bt, Ct)
    _close(scan(u, dt, Bt, Ct, A, D), want, 1e-5)


def test_causal_conv_reads_nothing_across_a_start():
    x = torch.randn(2, S, 8)
    w, b = torch.randn(8, 4), torch.randn(8)
    starts = mamba.segment_starts(torch.as_tensor(SEGS))
    want = _alone(lambda s: mamba.causal_conv(s, w, b), x)
    _close(mamba.causal_conv(x, w, b, starts), want, 1e-6)


# --------------------------------------------------------------------------- #
# The Mamba layer and the stack
# --------------------------------------------------------------------------- #
def _layer_cfg(**kw):
    m = hybrid.dims(_cfg())
    return dataclasses.replace(hybrid.port_config(_cfg(), m), **kw)


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_mamba_layer_packed_row_equals_each_segment_alone(impl):
    cfg = _layer_cfg()
    gen = torch.Generator().manual_seed(0)
    p1 = {k: v.requires_grad_(True) if not isinstance(v, dict) else
          {"scale": (v["scale"] * 1.1).requires_grad_(True)}
          for k, v in mamba.init(gen, cfg).items()}
    p2 = {k: (v.detach().clone().requires_grad_(True) if not isinstance(v, dict) else
              {"scale": v["scale"].detach().clone().requires_grad_(True)})
          for k, v in p1.items()}
    x = torch.randn(2, S, cfg.d_model, generator=gen)
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    w = torch.randn(x.shape, generator=gen)
    seg = torch.as_tensor(SEGS)
    y = mamba.apply(p1, x1, cfg, impl=impl, segment_ids=seg)
    (y * w).sum().backward()
    want = _alone(lambda s: mamba.apply(p2, s, cfg, impl="naive"), x2)
    (want * w).sum().backward()
    _close(y, want, 1e-5)
    _close(x1.grad, x2.grad, 1e-5)
    for k in p1:
        a, b = (p1[k], p2[k]) if not isinstance(p1[k], dict) else (p1[k]["scale"], p2[k]["scale"])
        _close(a.grad, b.grad, 1e-5)


def test_without_reset_the_layer_runs_across_segments():
    cfg = _layer_cfg(ssm_segment_reset=False)
    p = mamba.init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(2, S, cfg.d_model)
    seg = torch.as_tensor(SEGS)
    across = mamba.apply(p, x, cfg, impl="naive", segment_ids=seg)
    _close(across, mamba.apply(p, x, cfg, impl="naive"), 0.0)
    reset = mamba.apply(p, x, dataclasses.replace(cfg, ssm_segment_reset=True), impl="naive",
                        segment_ids=seg)
    assert float((reset - across)[0, 10:].abs().max()) > 1e-3


def test_inner_norms_are_parameters_and_counted():
    cfg = _layer_cfg()
    p = mamba.init(torch.Generator().manual_seed(0), cfg)
    R, N = mamba.dims(cfg)[1], cfg.ssm_d_state
    assert p["dt_norm"]["scale"].shape == (R,) and p["b_norm"]["scale"].shape == (N,)
    without = dataclasses.replace(cfg, ssm_inner_norms=False)
    assert "dt_norm" not in mamba.init(torch.Generator().manual_seed(0), without)
    n_mamba = sum(k.value == "mamba" for k in cfg.layer_kinds)
    assert cfg.param_count() - without.param_count() == n_mamba * (R + 2 * N)


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, vocab, SEGS.shape).astype(np.int32)
    labels = np.where(SEGS > 0, np.roll(tokens, -1, axis=1), -1).astype(np.int32)
    for b in range(SEGS.shape[0]):
        for a, e in _bounds(SEGS[b]):
            labels[b, e - 1] = -1
    positions = np.zeros_like(tokens)
    for b in range(SEGS.shape[0]):
        for a, e in _bounds(SEGS[b]):
            positions[b, a:e] = np.arange(e - a)
    return {"tokens": tokens, "labels": labels, "segment_ids": SEGS.copy(),
            "positions": positions}


def _ref_logits(w, m, tokens, seg):
    x = w["embed"][torch.as_tensor(tokens, dtype=torch.long)]
    for i in range(m.n_layers):
        x = REF.layer(x, w, i, m.eps, _bounds(seg))
    return REF.rms(x, w["final_norm"], m.eps) @ w["embed"].t()


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_tiny_jamba_matches_the_reference(impl):
    cfg = _cfg()
    m = hybrid.dims(cfg)
    assert m.attn_layers == (1, 3) and m.kv_heads == 1
    mc = hybrid.port_config(cfg, m)
    w = hybrid.make(m, 11, "cpu")
    params = hybrid.port_tree(m, {k: v.clone() for k, v in w.items()})
    ref_w = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    b = _batch(0, m.vocab)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    ctx = FwdCtx(ssm_impl=impl, attn_impl="kernel")
    logits, _, _ = model.forward(params, mc, tokens=t["tokens"], positions=t["positions"],
                                 segment_ids=t["segment_ids"], ctx=ctx)
    for r in range(2):
        _close(logits[r], _ref_logits(ref_w, m, b["tokens"][r], SEGS[r]).detach(), 1e-4)
    loss = step.make_loss_fn(mc, ctx)(params, t)
    count = int((b["labels"] >= 0).sum())
    ref_loss = sum(REF.row_nll_sum(ref_w, {"eps": m.eps}, b["tokens"][r], b["labels"][r],
                                   SEGS[r], b["positions"][r], torch.float32)
                   for r in range(2)) / count
    _close(loss, ref_loss, 1e-5)
    loss.backward()
    ref_loss.backward()
    named = {hybrid.leaf_name(p): x for p, x in tree_paths(params)}
    assert set(named) == set(ref_w)
    for k, x in named.items():
        _close(x.grad, ref_w[k].grad, 1e-4)


def test_two_adamw_steps_track_the_reference():
    cfg = _cfg()
    m = hybrid.dims(cfg)
    mc = hybrid.port_config(cfg, m)
    w = hybrid.make(m, 12, "cpu")
    params = hybrid.port_tree(m, {k: v.clone() for k, v in w.items()})
    opt = optim.adamw_init(params)
    train = step.make_train_step(mc, optim.AdamWConfig(**OPT), ctx=FwdCtx(ssm_impl="kernel"))
    batches = [{k: np.stack([v, v[::-1]]) for k, v in _batch(s, m.vocab).items()}
               for s in (1, 2)]
    losses = []
    for bt in batches:
        params, opt, met = train(params, opt, step.as_tensors(bt, device="cpu"), OPT["lr"])
        losses.append(float(met["loss"]))
    ref = REF.train({k: v.clone() for k, v in w.items()}, {"eps": m.eps}, batches, OPT)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    named = {hybrid.leaf_name(p): x for p, x in tree_paths(params)}
    for k, x in named.items():
        d, d_ref = x.detach() - w[k], ref["params"][k] - w[k]
        gap = float(torch.linalg.vector_norm(d - d_ref))
        assert gap <= 5e-3 * float(torch.linalg.vector_norm(d_ref)) + 1e-9, k


def test_mqa_at_g20_on_the_plain_attention_path():
    """K1-K3's plain versions at 20 query heads on 1 KV head (Jamba2-3B's
    G), against the reference's attention, forward and gradients."""
    g = torch.Generator().manual_seed(5)
    q = torch.randn(1, S, 20, 16, generator=g)
    k, v = torch.randn(1, S, 1, 16, generator=g), torch.randn(1, S, 1, 16, generator=g)
    w = torch.randn(1, S, 20, 16, generator=g)
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    rs = [x[0].clone().requires_grad_(True) for x in (q, k, v)]
    o = kops.packed_flash_attention(*qs, segment_ids=torch.as_tensor(SEGS[:1]), block_q=16,
                                    block_k=16)
    (o * w).sum().backward()
    want = REF.attention(*rs, _bounds(SEGS[0]))
    (want * w[0]).sum().backward()
    _close(o[0], want, 1e-5)
    for a, b in zip(qs, rs):
        _close(a.grad[0], b.grad, 1e-5)


# --------------------------------------------------------------------------- #
# The benchmark's arithmetic and readers
# --------------------------------------------------------------------------- #
def test_jamba2_3b_config_and_mfu_count_by_hand():
    cfg = json.loads((ROOT / "portbench/configs/jamba2-3b.json").read_text())
    m = hybrid.dims(cfg)
    assert cfg["mamba_dt_rank"] == m.dt_rank == 160 and m.attn_layers == (7, 21)
    attn = 2560 * 128 * (2 * 20 + 2 * 1)
    mix = 2560 * 10240 + 5120 * (160 + 32) + 160 * 5120 + 5120 * 2560
    ffn = 3 * 2560 * 8192
    assert m.matmul_params == 2 * attn + 26 * mix + 28 * ffn + 2560 * 65536 == 3_026_124_800
    seg = np.array([[1] * 3000 + [2] * 5000 + [0] * 192])
    pairs = 3000 * 3001 // 2 + 5000 * 5001 // 2
    assert formulas.step_model_flops(m, seg) == \
        6.0 * 3_026_124_800 * 8000 + 12.0 * 128 * 20 * 2 * pairs
    # the port's configuration of it: restarts, inner norms, the tied head
    mc = hybrid.port_config(cfg, m)
    assert mc.tie_embeddings and mc.ssm_segment_reset and mc.ssm_inner_norms


def test_scan_bounds_by_hand():
    """The bound counts what the scan needs (u, dt, B_t, C_t, A, D, the
    words in; y out; K5: dy in, the gradients out in the types returned);
    the port's fp32 states and partials are counted apart."""
    b = scan_bounds(1, 8192, 5120, 16, 2)
    seq, bc, small = 8192 * 5120 * 2, 8192 * 16 * 2, 5120 * 16 * 4 + 5120 * 4 + 256 * 4
    k4 = 3 * seq + 2 * bc + small
    k5 = 5 * seq + 4 * bc + small + 5120 * 16 * 4 + 5120 * 4
    assert b["K4"] == max(6.0 * 8192 * 5120 * 16 / 67e12, k4 / 3.35e12)
    assert b["K5"] == max(12.0 * 8192 * 5120 * 16 / 67e12, k5 / 3.35e12)
    states = 512 * 5120 * 16 * 4
    assert design_bytes(1, 8192, 5120, 16) == {
        "K4": states,
        "K5": states + 2 * 8192 * 5120 * 4 + 5120 * 16 * 4 + 5120 * 4 + 2 * 40 * 8192 * 16 * 4}


def _rec(ops, steps=2, segs=((1,) * 8192,)):
    return {"trace": {"device_ops": ops, "steps": [{"segment_ids": np.array([segs] * 4)}] * steps,
                      "host_ops": [], "span": (0.0, 1.0)},
            "dims": hybrid.dims(json.loads((ROOT / "portbench/configs/jamba2-3b.json")
                                           .read_text()))}


def test_scan_readers():
    k4 = "void (anonymous namespace)::fwd_kernel<__nv_bfloat16, 16, true>(...)"
    k5 = "void (anonymous namespace)::bwd_kernel<__nv_bfloat16, 16, true, true>(...)"
    ops = [(k4, 0.0, 0.001), (k4, 0.1, 0.101), (k5, 0.2, 0.204), ("gemm", 0.3, 0.4)]
    rec = _rec(ops)
    assert scan_ms.read(rec) == pytest.approx(1e3 * 0.006 / 2)
    b = scan_bounds(1, 8192, 5120, 16, 2)
    assert scan_roofline.read(rec) == pytest.approx(100 * (2 * b["K4"] + b["K5"]) / 0.006)
    dense = _rec([("gemm", 0.0, 0.1)])
    assert scan_ms.read(dense) is None and scan_roofline.read(dense) is None
    assert scan_roofline.read({**rec, "dims": object()}) is None


def test_layer_mamba_spans_and_the_segment_starts_counter():
    cfg = _cfg(num_hidden_layers=2)
    m = hybrid.dims(cfg)
    mc = hybrid.port_config(cfg, m)
    params = hybrid.port_tree(m, hybrid.make(m, 3, "cpu"))
    opt = optim.adamw_init(params)
    train = step.make_train_step(mc, optim.AdamWConfig(**OPT), ctx=FwdCtx(ssm_impl="kernel"))
    b = {k: np.stack([v[:1], v[1:]]) for k, v in _batch(4, m.vocab).items()}   # 2 microbatches
    try:
        with trace.recording() as rec:
            train(params, opt, step.as_tensors(b, device="cpu"), OPT["lr"])
        spans = [s for s in rec.spans() if s["name"] == "layer.mamba"]
        counters = rec.counters()
    finally:
        trace.recorder().clear()
    # layer 0 is Mamba: forward and recompute in each of 2 microbatches
    assert sorted((s["args"]["microbatch"], s["args"]["recompute"]) for s in spans) == \
        [(0, False), (0, True), (1, False), (1, True)]
    assert {s["args"]["layer"] for s in spans} == {0}
    starts = [c for c in counters if c["name"] == "mamba.segment_starts"]
    assert [c["value"] for c in starts] == [float(np.count_nonzero(np.diff(SEGS, axis=1)))]
    # untraced, nothing is counted and nothing recorded
    assert step.as_tensors(b, device="cpu").segment_starts is None


def test_restarts_are_made_once_a_microbatch(monkeypatch):
    """``model.forward`` makes the rows' restarts once and hands them to
    every Mamba layer, in the forward and in the backward's recompute."""
    cfg = _cfg(num_hidden_layers=4, attn_layer_period=4, attn_layer_offset=3)
    m = hybrid.dims(cfg)
    mc = hybrid.port_config(cfg, m)
    params = hybrid.port_tree(m, hybrid.make(m, 3, "cpu"))
    made, seen = [], []
    make, apply = mamba.make_restarts, mamba.apply
    monkeypatch.setattr(mamba, "make_restarts", lambda *a, **k: made.append(1) or make(*a, **k))
    monkeypatch.setattr(mamba, "apply", lambda *a, **k: seen.append(k["restarts"]) or
                        apply(*a, **k))
    train = step.make_train_step(mc, optim.AdamWConfig(**OPT), ctx=FwdCtx(ssm_impl="kernel"))
    b = {k: np.stack([v[:1], v[1:]]) for k, v in _batch(4, m.vocab).items()}   # 2 microbatches
    train(params, optim.adamw_init(params), step.as_tensors(b, device="cpu"), OPT["lr"])
    assert len(made) == 2
    assert len(seen) == 2 * 2 * 3 and all(r is not None and r.words is not None for r in seen)
    assert len({id(r) for r in seen}) == 2


def test_mamba_ms_reads_the_program_spans(monkeypatch):
    from repro_torch.runtime import trace as rtrace

    class Recorder:
        def spans(self):
            mk = lambda name, ms, mirrored=True: {"name": name, "device_ms": ms, "tid": 1,  # noqa: E731
                                                  "mirrored": mirrored}
            return [mk("layer.mamba", 2.0), {**mk("layer.mamba", 3.0, False), "tid": 2},
                    mk("step.forward", 9.0), mk("layer.mamba", None)]

    monkeypatch.setattr(rtrace, "recorder", lambda: Recorder())
    assert mamba_ms.read(_rec([])) == pytest.approx(5.0 / 2)
    monkeypatch.setattr(rtrace, "recorder", lambda: type("R", (), {"spans": lambda s: []})())
    assert mamba_ms.read(_rec([])) is None
