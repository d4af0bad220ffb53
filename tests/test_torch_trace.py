"""The program's own spans (``repro_torch.common.trace``): the process's
recorder over a tiny ``ScheduledLoader`` and ``make_train_step`` on the CPU.

- Off (the default, no profiler), a span records nothing, opens no
  ``record_function`` and makes no device event.
- On, each span carries the global batch it works on and its parent, on
  the caller's thread and on the scheduler's worker thread; the worker
  thread's ``sched.schedule`` spans say the search ran in the scheduler's
  worker process (``where``) and how many nodes it visited (``nodes``).
- Under a CPU ``torch.profiler``, the caller's spans are mirrored into the
  profile as ``repro_torch.<span>``; after the one offset (the median gap
  between a span's two copies, as the benchmark's ``idle_in_search_ms``
  takes it), each maps onto its copy within 0.2 ms, and
  each worker span falls inside its batch's interval (submitted after the
  previous batch was collected, finished before its own collect ended).
- On a card (``gpu``): device spans resolve after the step, and nothing in
  the step waits for them.
- The loader, the scheduler and the train step load the recorder without
  the runtime package.

Every test that switches the recorder on switches it off again (xdist runs
many tests in one process).
"""
import json
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.common.types import ModelConfig
from repro_torch.core.engine import DFLOPEngine
from repro_torch.core.optimizer.space import ClusterSpec, ModuleParallelism, ParallelismPlan
from repro_torch.core.profiling.analytic import V5E, AnalyticBackend
from repro_torch.data.loader import ScheduledLoader
from repro_torch.data.synthetic import MixedDataset
from repro_torch.models import model as model_lib
from repro_torch.models.model import FwdCtx
from portbench.metrics import idle_in_search_ms
from repro_torch.common import trace
from repro_torch.runtime import TraceRecorder
from repro_torch.train import optim, step

torch.set_num_threads(1)

TPM, GBS, BUDGET, VOCAB, N_MB = 8, 8, 128, 256, 2
LLM = ModelConfig(name="trace-tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab_size=VOCAB, dtype="float32")
STEP_SPANS = ("step.h2d", "step.train", "step.forward", "step.backward", "step.optimizer")
MAP_US = 200.0          # a mirrored span's largest gap from its profile copy


@pytest.fixture
def off_after():
    """The process recorder as a test leaves it: off and empty."""
    yield trace.recorder()
    trace.recorder().enabled = False
    trace.recorder().clear()
    trace.set_batch(None)
    trace._profiled = None


def _program(n_batches: int, device="cpu"):
    """A scheduled loader over ``n_batches`` seeded global batches (two
    microbatches of one row) and a tiny decoder's train step."""
    eng = DFLOPEngine(llm_cfg=LLM, cluster=ClusterSpec(n_chips=1, chips_per_node=1),
                      tokens_per_media_item=TPM, backend=AnalyticBackend(V5E))
    eng.profile(MixedDataset("mixed", seed=0, tokens_per_media_item=TPM), n_samples=128)
    sched = eng.scheduler(plan=ParallelismPlan(llm=ModuleParallelism(1, 1, 1), n_mb=N_MB),
                          ilp_time_limit_s=0.0)
    ds = MixedDataset("single_image", seed=3, tokens_per_media_item=TPM)
    source = [ds.sample(GBS) for _ in range(n_batches)]
    loader = ScheduledLoader(None, sched, gbs=GBS, token_budget=BUDGET, vocab_size=VOCAB,
                             seed=1, item_source=source)
    params = model_lib.init(LLM, seed=0, device=device)
    state = {"params": params, "opt": optim.adamw_init(params)}
    fn = step.make_train_step(LLM, optim.AdamWConfig(lr=1e-3), ctx=FwdCtx(attn_impl="naive"))

    def train(batch):
        state["params"], state["opt"], met = fn(state["params"], state["opt"],
                                                step.as_tensors(batch, device=device), 1e-3)
        return met

    return sched, iter(loader), train


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_opens_nothing(off_after, monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "_mirror", lambda name: calls.append(name))
    monkeypatch.setattr(trace, "_device_event", lambda: calls.append("event"))
    sched, batches, train = _program(3)
    for _ in range(3):
        train(next(batches))
    sched._pool.shutdown(wait=True)
    assert not trace.recorder().enabled and len(trace.recorder()) == 0 and calls == []
    assert trace.span("step.forward", cat="step", device=True) is trace._OFF
    assert trace.recorder().device_ms() is None and trace.recorder().spans() == []


def test_on_gives_each_span_its_batch_and_parent(off_after):
    sched, batches, train = _program(4)
    with trace.recording() as rec:
        for _ in range(3):
            train(next(batches))
        sched._pool.shutdown(wait=True)
    assert not rec.enabled
    by = _by_name(rec.spans())
    # the caller's spans: each of the three batches once (forward and
    # backward once a microbatch); the step's phases under its step.train
    for name in ("loader.pack", "step.h2d", "step.train", "step.optimizer"):
        assert [s["batch"] for s in by[name]] == [0, 1, 2], name
    for name in ("step.forward", "step.backward"):
        assert [s["batch"] for s in by[name]] == [0, 0, 1, 1, 2, 2], name
        assert [s["args"]["microbatch"] for s in by[name]] == [0, 1] * 3
    trains = {s["batch"]: s["id"] for s in by["step.train"]}
    for name in ("step.forward", "step.backward", "step.optimizer"):
        assert all(s["parent"] == trains[s["batch"]] for s in by[name]), name
    for name in ("loader.collect", "loader.pack", "step.h2d", "step.train"):
        assert all(s["parent"] is None for s in by[name]), name
    assert [s["batch"] for s in by["loader.collect"]] == [0, 1, 2]
    assert {s["thread"] for n in STEP_SPANS + ("loader.pack",) for s in by[n]} == \
        {"MainThread"}
    # the worker's searches: batches 0-3 (batch 3 prefetched while 2 trained)
    sch = by["sched.schedule"]
    assert [s["batch"] for s in sch] == [0, 1, 2, 3]
    assert all(s["thread"] != "MainThread" and s["parent"] is None for s in sch)
    assert all(s["args"]["items"] == GBS and s["args"]["buckets"] == N_MB
               and s["args"]["solver"] in ("ilp", "ilp-timeout") for s in sch)
    # searched in the scheduler's worker process, its nodes counted
    assert all(s["args"]["where"] == "worker" and type(s["args"]["nodes"]) is int
               and s["args"]["nodes"] >= 1 for s in sch)
    assert all(not s["mirrored"] and s["device_ms"] is None for s in rec.spans())
    assert all(s["args"]["items"] == GBS and s["args"]["truncated"] >= 0
               for s in by["loader.pack"])
    # the export: one lane a thread, named
    doc = rec.to_chrome()
    lanes = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert "MainThread" in lanes and len(lanes) == 2
    assert json.loads(json.dumps(doc)) == doc


def _mapping(prof, spans):
    """(offset, worst gap, the mirrored spans by name): each mirrored span
    against its copy in the profile, the offset the median of their gaps."""
    mine = _by_name([s for s in spans if s["mirrored"]])
    assert set(mine) == {"loader.collect", "loader.pack"} | set(STEP_SPANS)
    assert all(s["thread"] == "MainThread" for v in mine.values() for s in v)
    host = [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6) for e in prof.events()]
    gaps = idle_in_search_ms.mirror_gaps(spans, host)
    assert len(gaps) == sum(len(v) for v in mine.values())   # every name paired
    offset = idle_in_search_ms.offset_us(spans, host)
    return offset, max(abs(d - offset) for _, a, b in gaps for d in (a, b)), mine


def test_mirrored_spans_map_onto_the_profile(off_after):
    """Three profiled steps after an unprofiled one, as the benchmark's
    traced steps follow its window.  A loaded CPU may take the thread away
    between a span's stamp and the profiler's: a second or third attempt,
    on the next steps, must then map every span."""
    attempts = 3
    sched, batches, train = _program(4 * attempts + 1)
    worst = []
    for k in range(attempts):
        train(next(batches))                  # batch 4k, before the profiler
        trace.recorder().clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                train(next(batches))          # batches 4k+1 .. 4k+3
        sched._pending.result()               # the search for batch 4k+4
        assert trace.recorder().enabled is False
        spans = trace.recorder().spans()
        offset, gap, mine = _mapping(prof, spans)
        worst.append(gap)
        if gap <= MAP_US:
            break
    assert worst[-1] <= MAP_US, worst
    # the worker's searches begun under the profiler, mapped by that offset
    # into their batches' intervals
    first = 4 * k + 1
    collect = {s["batch"]: s for s in mine["loader.collect"]}
    sch = {s["batch"]: s for s in spans if s["name"] == "sched.schedule"
           and s["batch"] > first}
    assert sorted(sch) == [first + 1, first + 2, first + 3]
    for b in (first + 1, first + 2):
        start = sch[b]["ts_us"] + offset
        end = start + sch[b]["dur_us"]
        prev = collect[b - 1]
        assert prev["ts_us"] + prev["dur_us"] + offset - MAP_US <= start, b
        assert end <= collect[b]["ts_us"] + collect[b]["dur_us"] + offset + MAP_US, b
    sched._pool.shutdown(wait=True)


def test_recording_clears_and_restores(off_after):
    rec = trace.recorder()
    with trace.recording():
        with trace.span("a", cat="t", batch=7) as sp:
            sp.set(n=1)
            with trace.span("b", cat="t"):
                pass
    got = rec.spans()
    assert [(s["name"], s["batch"], s["args"]) for s in got] == [("b", None, {}),
                                                                 ("a", 7, {"n": 1})]
    assert got[0]["parent"] == got[1]["id"] and got[1]["parent"] is None
    with trace.recording(False):
        assert not rec.enabled and len(rec) == 2
    with trace.recording():
        assert len(rec) == 0
    assert not rec.enabled


def test_a_recorder_of_its_own_keeps_the_reference_export():
    """A recorder that holds no program span exports as it did: no lane, no
    device slice (the controller's traces compare with the reference)."""
    clock = iter(np.arange(10) * 1e-3)
    rec = TraceRecorder(clock=lambda: next(clock))
    with rec.span("schedule", cat="scheduler"):
        pass
    evs = rec.to_chrome()["traceEvents"]
    assert [e["ph"] for e in evs] == ["M", "X"] and evs[1]["tid"] == 0
    assert rec.device_ms() is None


@pytest.mark.gpu
def test_device_spans_resolve_after_the_step(off_after, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sched, batches, train = _program(3, device="cuda")
    train(next(batches))
    batch = next(batches)           # both steps train it: the same launches
    torch.cuda.synchronize()
    resolved = []
    real = trace.TraceRecorder._resolve
    monkeypatch.setattr(trace.TraceRecorder, "_resolve",
                        lambda self: resolved.append(1) or real(self))
    syncs = []                      # (tracing on, the step's sync warnings)
    for on in (False, True, False):
        with trace.recording(on), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            resolved.clear()
            try:
                train(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            syncs.append((on, [str(w.message)[:80] for w in caught
                               if "synchroniz" in str(w.message)]))
            assert resolved == []             # nothing read inside the step
            torch.cuda.synchronize()
            if on:
                spans = trace.recorder().spans()
    sched._pool.shutdown(wait=True)
    # tracing adds none (the first step of the three may warn once more)
    assert len(syncs[1][1]) <= min(len(syncs[0][1]), len(syncs[2][1])), syncs
    by = _by_name(spans)
    for name in ("step.forward", "step.backward", "step.optimizer"):
        assert by[name] and all(s["device_ms"] > 0 for s in by[name]), name
    assert all(s["device_ms"] is None for s in by["step.train"])
    doc = trace.recorder().to_chrome()
    lane = [e for e in doc["traceEvents"] if e.get("tid") == trace.DEVICE_TID
            and e["ph"] == "X"]
    assert len(lane) == 2 * N_MB + 1


def test_the_layers_load_the_recorder_without_the_runtime():
    code = ("import sys, repro_torch.data.loader, repro_torch.train.step; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.runtime')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.split() == ["[]"]
    from repro_torch.runtime import trace as runtime_trace
    assert runtime_trace.recorder() is trace.recorder()
    assert runtime_trace.TraceRecorder is TraceRecorder is trace.TraceRecorder
