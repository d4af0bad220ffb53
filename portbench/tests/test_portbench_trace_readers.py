"""The readers of the program's spans (``fwd_ms``, ``bwd_ms``, ``optim_ms``,
``pack_ms``, ``sched_search_ms``, ``idle_in_search_ms``) on a synthetic
recorder and trace: each returns its number, and None where the recorder,
its spans or the trace are missing (as at a commit whose program records
none).  A tiny traced run on the CPU reads the host spans and, with no
device there, no device number."""
import pytest

import tiny
from portbench import core
from repro_torch.common import trace as program_trace
from repro_torch.runtime import trace

NAMES = ("fwd_ms", "bwd_ms", "optim_ms", "pack_ms", "sched_search_ms", "idle_in_search_ms")
OFF_US = 1000.0          # the profile's clock minus the recorder's


def _span(name, ts_ms, dur_ms, *, tid=100, mirrored=True, device_ms=None):
    return {"name": name, "cat": "x", "ts_us": ts_ms * 1e3 - OFF_US, "dur_us": dur_ms * 1e3,
            "tid": tid, "thread": "t", "id": 1, "parent": None, "batch": 0,
            "mirrored": mirrored, "device_ms": device_ms, "args": {}}


SPANS = [_span("loader.pack", 2, 4),
         _span("step.forward", 10, 90, device_ms=30.0),
         _span("step.forward", 120, 80, device_ms=50.0),
         _span("step.backward", 700, 100, device_ms=60.0),
         _span("step.optimizer", 850, 100, device_ms=20.0),
         _span("step.train", 8, 950),
         _span("sched.schedule", 200, 400, tid=101, mirrored=False)]
HOST = [("repro_torch." + s["name"], (s["ts_us"] + OFF_US) / 1e6,
         (s["ts_us"] + s["dur_us"] + OFF_US) / 1e6) for s in SPANS if s["mirrored"]]
TRACE = {"steps": [{}, {}], "span": (0.0, 1.0), "host_ops": HOST + [("aten::mm", 0.1, 0.2)],
         "device_ops": [("k", 0.0, 0.2), ("k", 0.5, 1.0)]}
WANT = {"fwd_ms": 40.0, "bwd_ms": 30.0, "optim_ms": 10.0, "pack_ms": 2.0,
        "sched_search_ms": 200.0, "idle_in_search_ms": 150.0}


class _Rec:
    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return list(self._spans)


def _read(name, rec):
    return core.load_module("metrics", name).read(rec)


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_reads_its_number(name, monkeypatch):
    monkeypatch.setattr(trace, "recorder", lambda: _Rec(SPANS))
    assert _read(name, {"trace": TRACE}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_finds_nothing(name, monkeypatch):
    monkeypatch.setattr(trace, "recorder", lambda: _Rec(SPANS))
    assert _read(name, {"trace": None}) is None
    assert _read(name, {"trace": {**TRACE, "steps": []}}) is None
    monkeypatch.setattr(trace, "recorder", lambda: _Rec([]))
    assert _read(name, {"trace": TRACE}) is None
    monkeypatch.delattr(trace, "recorder")            # a program without the spans
    assert _read(name, {"trace": TRACE}) is None


def test_idle_in_search_needs_the_mirrored_copies(monkeypatch):
    monkeypatch.setattr(trace, "recorder", lambda: _Rec(SPANS))
    no_copies = {**TRACE, "host_ops": [("aten::mm", 0.1, 0.2)]}
    assert _read("idle_in_search_ms", {"trace": no_copies}) is None
    assert _read("idle_in_search_ms", {"trace": {**TRACE, "device_ops": []}}) is None


def test_a_tiny_traced_run_reads_the_host_spans():
    drv = core.load_module("drivers", "dflop_train")
    try:
        rec = drv.run(tiny.cell(), 2 ** 31 + 5, 0.5, True, device="cpu")
        got = {n: _read(n, rec) for n in NAMES}
    finally:
        trace.recorder().clear()
        program_trace._profiled = None    # the profiled thread's switch, off
    assert got["pack_ms"] > 0 and got["sched_search_ms"] > 0
    # the CPU has no device events and no device operations
    assert got["fwd_ms"] is None and got["idle_in_search_ms"] is None
