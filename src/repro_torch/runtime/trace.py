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
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

_PID = 1


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

    # ------------------------------------------------------------------ #
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def name_thread(self, tid: int, name: str) -> None:
        self._thread_names[tid] = name

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

    def to_chrome(self) -> dict:
        """Format the buffer as a Chrome-trace JSON object."""
        out: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
            "args": {"name": self.process_name},
        }]
        for tid, name in sorted(self._thread_names.items()):
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
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self._dropped}}

    def export(self, path: str) -> str:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path
