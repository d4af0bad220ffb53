"""Low-overhead span recorder with Chrome-trace (Perfetto) JSON export.

The runtime control loop needs to *see* bubble structure, not just infer it:
every step / stage / microbatch event is recorded as a (category, name,
ts, dur) tuple on the hot path — one list append, no dict construction,
no I/O — and formatted into the Chrome ``traceEvents`` schema only at
export time.  Load the exported file in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing`` to inspect pipeline bubbles span-by-span.

Event kinds map onto trace phases:
  span()/complete() -> "X" (complete slice: ts + dur)
  instant()         -> "i" (e.g. plan hot-swap markers)
  counter()         -> "C" (rolling metrics: imbalance, bubble fraction)

A leaf module: it imports nothing else of the package, so the loader, the
scheduler and the train step write their spans without loading the runtime
package (``repro_torch.runtime.trace`` re-exports it for the controller).

The process's recorder (``recorder()``) holds the program's own spans:
the loader's, the scheduler's and the train step's, written through
``span()``.  It is off by default.  It records while a caller switches it
on (``recording()``: ``train_mllm --trace``) and, with no switch, for as
long as a ``torch.profiler`` session records on the thread that runs the
step; the state is process-wide, so the scheduler's worker thread records
too.  Its clock is the wall clock the profiler stamps its events with, and
on the profiled thread each span also opens a ``record_function`` of the
same name (``repro_torch.<span>``): those copies lie in the profile beside
the device's operations, and give the one offset that puts every span, of
any thread, onto the profile's timeline.  A span opened with
``device=True`` also records a CUDA event at each edge on the current
stream; the pairs are resolved into device milliseconds when the spans are
read or exported, never inside the step.  Off, a span costs a query of the
profiler's state and a flag test: no record, no event, no
``record_function``, nothing that waits for the device.  ``counter()``
records a value under the same switch (``TraceRecorder.counters()`` reads
them); ``set_microbatch()`` names the microbatch the step works on, for
spans that run outside the step's own spans (a layer's recompute in the
backward, on autograd's thread).
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch._C._autograd import _profiler_enabled

_PID = 1
DEVICE_TID = 99       # Chrome lane of the device spans
THREAD_TID0 = 100     # Chrome lanes of the program spans' threads start here


class TraceRecorder:
    """Append-only event buffer; thread-safe, bounded, cheap when disabled."""

    def __init__(self, *, enabled: bool = True, max_events: int = 1_000_000,
                 process_name: str = "dflop-runtime",
                 clock=time.monotonic):
        self.enabled = enabled
        self.max_events = max_events
        self.process_name = process_name
        self._clock = clock
        self._t0 = clock()
        self._events: List[tuple] = []      # (ph, name, cat, ts_us, dur_us, tid, args)
        self._dropped = 0
        self._lock = threading.Lock()
        self._thread_names: Dict[int, str] = {}
        self._lanes: Dict[int, int] = {}     # thread ident -> Chrome lane
        self._ids = itertools.count(1)
        self._device: List[list] = []       # [span id, batch, host ts_us, start, end, ms, at_ms]
        self._anchor = None                  # the first device span's start event

    # ------------------------------------------------------------------ #
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def name_thread(self, tid: int, name: str) -> None:
        self._thread_names[tid] = name

    def lane(self) -> int:
        """The Chrome lane of the calling thread's program spans."""
        ident = threading.get_ident()
        tid = self._lanes.get(ident)
        if tid is None:
            with self._lock:
                tid = self._lanes.setdefault(ident, THREAD_TID0 + len(self._lanes))
            self._thread_names[tid] = threading.current_thread().name
        return tid

    def _push(self, ev: tuple) -> None:
        with self._lock:
            if len(self._events) >= self.max_events:
                self._dropped += 1
                return
            self._events.append(ev)

    # ------------------------------------------------------------------ #
    @contextmanager
    def span(self, name: str, *, cat: str = "runtime", tid: int = 0, **args):
        """Time a block as a complete slice.  ~1 µs overhead when enabled."""
        if not self.enabled:
            yield self
            return
        ts = self.now_us()
        try:
            yield self
        finally:
            self._push(("X", name, cat, ts, self.now_us() - ts, tid,
                        args or None))

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "runtime", tid: int = 0,
                 args: Optional[dict] = None) -> None:
        """Record a slice with explicit timestamps (simulated schedules,
        device timelines reconstructed after the fact)."""
        if self.enabled:
            self._push(("X", name, cat, ts_us, dur_us, tid, args))

    def instant(self, name: str, *, cat: str = "runtime", tid: int = 0,
                args: Optional[dict] = None) -> None:
        if self.enabled:
            self._push(("i", name, cat, self.now_us(), 0.0, tid, args))

    def counter(self, name: str, value: float, *, cat: str = "metrics",
                tid: int = 0) -> None:
        if self.enabled:
            self._push(("C", name, cat, self.now_us(), 0.0, tid,
                        {"value": float(value)}))

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        """Drop every event, device span and thread lane."""
        with self._lock:
            self._events.clear()
            self._device.clear()
            self._lanes.clear()
            self._thread_names.clear()
            self._anchor = None
            self._dropped = 0

    def _add_device(self, sid: int, batch, ts_us: float, start, end) -> None:
        with self._lock:
            if self._anchor is None:
                self._anchor = start
            self._device.append([sid, batch, ts_us, start, end, None, None])

    def _resolve(self) -> List[list]:
        """Device spans with their milliseconds, each pair's end event
        waited for here: reading or exporting, never inside a step."""
        with self._lock:
            device, anchor = list(self._device), self._anchor
        for d in device:
            if d[5] is None:
                d[4].synchronize()
                d[5] = d[3].elapsed_time(d[4])
                d[6] = anchor.elapsed_time(d[3])
                d[3] = d[4] = None          # the events' handles go back
        return device

    def spans(self) -> List[dict]:
        """Every complete slice, oldest first: ``name``, ``cat``, ``ts_us``
        and ``dur_us`` on the recorder's clock, ``thread`` (its name) and
        ``tid``; a program span's ``id``, ``parent`` (the enclosing span's
        id on its thread), ``batch`` (the global batch it works on),
        ``mirrored`` (a ``record_function`` copy lies in a profile) and
        ``device_ms`` (None without a device pair); ``args``, the rest."""
        device = {d[0]: d[5] for d in self._resolve()}
        with self._lock:
            events = [e for e in self._events if e[0] == "X"]
        out = []
        for _, name, cat, ts, dur, tid, args in events:
            args = dict(args or {})
            sid = args.pop("id", None)
            out.append({"name": name, "cat": cat, "ts_us": ts, "dur_us": dur, "tid": tid,
                        "thread": self._thread_names.get(tid), "id": sid,
                        "parent": args.pop("parent", None), "batch": args.pop("batch", None),
                        "mirrored": args.pop("mirrored", False),
                        "device_ms": device.get(sid), "args": args})
        return out

    def counters(self) -> List[dict]:
        """Every counter, oldest first: ``name``, ``ts_us``, ``value``,
        ``tid`` and the rest of its arguments (``batch``, where the
        program's ``counter()`` recorded it)."""
        with self._lock:
            events = [e for e in self._events if e[0] == "C"]
        return [{"name": name, "ts_us": ts, "tid": tid, **(args or {})}
                for _, name, _, ts, _, tid, args in events]

    def device_ms(self, batch: Optional[int] = None) -> Optional[float]:
        """Device milliseconds in the device spans (of ``batch``, if given);
        None where there are none."""
        ms = [d[5] for d in self._resolve() if batch is None or d[1] == batch]
        return sum(ms) if ms else None

    def _device_events(self) -> List[dict]:
        """The device spans as slices of the device lane.  A pair's events
        give its length and its distance from the first pair's start; the
        lane's origin is set so that no span starts on the device before
        the host recorded it, and the one that the device ran at once (the
        step after a synchronize starts so) starts with its host span."""
        device = self._resolve()
        if not device:
            return []
        origin = max(ts - at * 1e3 for _, _, ts, _, _, _, at in device)
        names = {}
        with self._lock:
            for e in self._events:
                if e[0] == "X" and e[6] and "id" in e[6]:
                    names[e[6]["id"]] = e
        out = []
        for sid, _, _, _, _, ms, at in device:
            if sid not in names:            # its host slice was dropped
                continue
            _, name, cat, _, _, _, args = names[sid]
            out.append({"ph": "X", "name": name, "cat": cat, "ts": origin + at * 1e3,
                        "dur": ms * 1e3, "pid": _PID, "tid": DEVICE_TID,
                        "args": {"batch": args.get("batch"), "span": sid}})
        return out

    def to_chrome(self) -> dict:
        """Format the buffer as a Chrome-trace JSON object."""
        out: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
            "args": {"name": self.process_name},
        }]
        device = self._device_events()
        names = dict(self._thread_names)
        if device:
            names[DEVICE_TID] = "device (CUDA events, stream order)"
        for tid, name in sorted(names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": _PID,
                        "tid": tid, "args": {"name": name}})
        with self._lock:
            events = list(self._events)
        for ph, name, cat, ts, dur, tid, args in events:
            ev = {"ph": ph, "name": name, "cat": cat, "ts": ts,
                  "pid": _PID, "tid": tid}
            if ph == "X":
                ev["dur"] = max(dur, 0.0)
            if ph == "i":
                ev["s"] = "p"               # process-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        out.extend(device)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self._dropped}}

    def export(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# --------------------------------------------------------------------------- #
# The process's recorder and the program's spans
# --------------------------------------------------------------------------- #
_RECORDER = TraceRecorder(enabled=False, process_name="repro_torch", clock=time.time)
_local = threading.local()        # per thread: the span stack and the batch index
_profiled: Optional[int] = None   # the thread whose profiler switched recording on
_microbatch: Optional[int] = None  # the microbatch the step works on (any thread)


def recorder() -> TraceRecorder:
    """The process's recorder of program spans (off by default)."""
    return _RECORDER


@contextmanager
def recording(on: bool = True):
    """Record the process's spans inside the block, from an empty recorder;
    ``on=False`` leaves the recorder as it is."""
    if not on:
        yield _RECORDER
        return
    was = _RECORDER.enabled
    _RECORDER.clear()
    _RECORDER.enabled = True
    try:
        yield _RECORDER
    finally:
        _RECORDER.enabled = was


def set_batch(index: Optional[int]) -> None:
    """The global batch that the calling thread's spans work on from now."""
    _local.batch = index


def set_microbatch(index: Optional[int]) -> None:
    """The microbatch the train step works on from now, for every thread
    (a checkpointed layer recomputes on autograd's thread)."""
    global _microbatch
    _microbatch = index


def microbatch() -> Optional[int]:
    return _microbatch


def active() -> bool:
    """Whether the program's spans and counters record now: the recorder is
    on, or a profiler records on this thread or on the step's."""
    return _RECORDER.enabled or _profiled is not None or _profiler_enabled()


def counter(name: str, value: float, *, cat: str, batch: Optional[int] = None) -> None:
    """A program counter: ``value`` under ``name`` at this moment, with the
    global batch (``batch``, else the thread's ``set_batch``), recorded
    when ``active()``."""
    if not active():
        return
    if batch is None:
        batch = getattr(_local, "batch", None)
    _RECORDER._push(("C", name, cat, _RECORDER.now_us(), 0.0, _RECORDER.lane(),
                     {"value": float(value), "batch": batch}))


class _Off:
    """The span of a recorder that is off: a shared no-op."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_OFF = _Off()


def span(name: str, *, cat: str, batch: Optional[int] = None, device: bool = False,
         **args):
    """A program span for a ``with`` block: its name, start, end, thread,
    parent span and global batch (``batch``, else the thread's
    ``set_batch``), under ``cat``.  ``device=True`` adds a CUDA event pair
    on the current stream; ``args`` (and ``.set(...)`` inside the block)
    land in the span's arguments."""
    global _profiled
    profiled = _profiler_enabled()          # the calling thread's profiler
    if profiled:
        if _profiled is None:
            _profiled = threading.get_ident()
            # a session's first record_function is slow to stamp: a marker
            # of where recording began takes that cost
            _mirror("repro_torch.trace").__exit__(None, None, None)
    elif _profiled is not None and _profiled == threading.get_ident():
        _profiled = None
    if _profiled is None and not _RECORDER.enabled:
        return _OFF
    return _Span(name, cat, batch, device, profiled, args)


def _mirror(name: str):
    """A ``record_function`` of ``name`` in the calling thread's profile,
    entered.  Its fast form keeps the interpreter lock: the op form gives it
    up, and where another thread takes it (the scheduler's search) the
    profiler stamps the copy up to milliseconds after the span's own stamp."""
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def _device_event():
    """A timing CUDA event recorded on the current stream, or None while
    CUDA has not been initialised in this process."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("name", "cat", "batch", "device", "mirror", "args", "id", "parent",
                 "t0", "ev", "rf")

    def __init__(self, name, cat, batch, device, mirror, args):
        self.name, self.cat, self.batch = name, cat, batch
        self.device, self.mirror, self.args = device, mirror, args

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if self.batch is None:
            self.batch = getattr(_local, "batch", None)
        self.parent = stack[-1] if stack else None
        self.id = next(_RECORDER._ids)
        stack.append(self.id)
        self.ev = _device_event() if self.device else None
        self.t0 = _RECORDER.now_us()       # each stamp just before the profiler's
        self.rf = _mirror("repro_torch." + self.name) if self.mirror else None
        return self

    def __exit__(self, *exc):
        t1 = _RECORDER.now_us()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        end = _device_event() if self.ev is not None else None
        _local.stack.pop()
        args = {"id": self.id, "parent": self.parent, "batch": self.batch,
                "mirrored": self.mirror, **self.args}
        _RECORDER._push(("X", self.name, self.cat, self.t0, t1 - self.t0,
                         _RECORDER.lane(), args))
        if end is not None:
            _RECORDER._add_device(self.id, self.batch, self.t0, self.ev, end)
        return False
