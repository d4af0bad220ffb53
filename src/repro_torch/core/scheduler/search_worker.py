"""The scheduler's search in a process of its own (paper §3.4.2: "the
scheduler operates asynchronously to eliminate scheduling overhead").

``solve_makespan_bnb`` is pure Python: on a thread of the training process
it holds the interpreter lock for its whole time limit, and the step's
thread, which packs the next batch and launches the forward's operations,
waits a switch interval for every turn it takes.  ``SearchWorker`` runs the
same function in a child process instead; the thread that asks for a search
blocks on the child's pipe, which gives the lock up.

The child is ``python -c`` over this module: it loads numpy, the
branch-and-bound and its LPT helpers, and never torch (this module, ``ilp``
and ``lpt`` import nothing else of the package, and the scheduler package
loads its torch-side exports on first use).  Messages are pickles behind a
4-byte length, one request and one reply at a time:

  ("solve", e_dur, l_dur, m, time_limit_s) -> (True, BnBResult)
  ("modules",)                             -> (True, sorted(sys.modules))

and ``(False, traceback text)`` for a request that raised.  The child exits
when its input ends, as it does when the parent dies, and ``close()`` ends
it at once.
"""
from __future__ import annotations

import pickle
import struct
import subprocess
import sys
import threading
import traceback
from pathlib import Path

_HEADER = struct.Struct("<I")
_SRC = str(Path(__file__).resolve().parents[3])     # the directory holding repro_torch
_ENTRY = ("import sys; sys.path.insert(0, {src!r}); "
          "from repro_torch.core.scheduler.search_worker import main; main()")


def _send(stream, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(_HEADER.pack(len(data)) + data)
    stream.flush()


def _recv(stream):
    """One message, or None where the stream ended."""
    head = stream.read(_HEADER.size)
    if len(head) < _HEADER.size:
        return None
    (n,) = _HEADER.unpack(head)
    data = stream.read(n)
    if len(data) < n:
        return None
    return pickle.loads(data)


class SearchWorker:
    """A long-lived child process that runs ``solve_makespan_bnb``."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _ENTRY.format(src=_SRC)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self._lock = threading.Lock()     # one request in flight

    def _call(self, *request):
        with self._lock:
            try:
                _send(self.proc.stdin, request)
                reply = _recv(self.proc.stdout)
            except (BrokenPipeError, ValueError):   # closed, or its pipe gone
                reply = None
        if reply is None:
            raise RuntimeError(f"the scheduler's search worker (pid {self.proc.pid}) "
                               f"exited with {self.proc.wait()}")
        ok, value = reply
        if not ok:
            raise RuntimeError(f"the scheduler's search worker raised:\n{value}")
        return value

    def solve(self, e_dur, l_dur, m: int, time_limit_s: float):
        """``solve_makespan_bnb(e_dur, l_dur, m, time_limit_s=...)``'s
        ``BnBResult``, computed in the child."""
        return self._call("solve", e_dur, l_dur, m, time_limit_s)

    def modules(self) -> list:
        """The names of the modules the child has loaded."""
        return self._call("modules")

    def close(self) -> None:
        """End the child (a search in flight is abandoned) and reap it."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        for stream in (self.proc.stdin, self.proc.stdout):
            try:
                stream.close()
            except OSError:       # a request the dead child never read
                pass


def main() -> None:
    """The child's loop: read a request, answer it, until input ends."""
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)    # the parent handles ^C
    from repro_torch.core.scheduler.ilp import solve_makespan_bnb
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        request = _recv(stdin)
        if request is None:
            return
        try:
            if request[0] == "solve":
                _, e_dur, l_dur, m, limit = request
                reply = (True, solve_makespan_bnb(e_dur, l_dur, m, time_limit_s=limit))
            elif request[0] == "modules":
                reply = (True, sorted(sys.modules))
            else:
                raise ValueError(f"unknown request {request[0]!r}")
        except Exception:
            reply = (False, traceback.format_exc())
        try:
            _send(stdout, reply)
        except BrokenPipeError:
            return
