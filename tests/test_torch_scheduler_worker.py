"""The Online Microbatch Scheduler's search worker
(``repro_torch.core.scheduler.search_worker``): ``submit()``/``collect()``
run the branch-and-bound in a child process of the scheduler's own.

- For every instance the search finishes, the groups are exactly what
  ``solve_makespan_bnb`` returns in this process.
- The child loads no torch; it starts once for a scheduler and is gone once
  the scheduler is shut down and collected.
- An error in the child, or its death, surfaces in ``collect()``.
- While a search that reaches its time limit runs, a thread of this process
  that packs and launches (here a loop that gives the interpreter lock up
  once a turn, as an operator launch does) makes at least twice the
  progress it makes beside the same search on a thread.
"""
import gc
import os
import time

import numpy as np
import pytest

from repro_torch.common import trace
from repro_torch.core.optimizer.space import ModuleParallelism, ParallelismPlan
from repro_torch.core.scheduler import OnlineMicrobatchScheduler
from repro_torch.core.scheduler.ilp import solve_makespan_bnb
from repro_torch.data.items import DataItem

LIMIT_S = 0.25          # ilp_time_limit_s of the benchmark's traffic


def _scheduler(e, l, m: int, limit: float = LIMIT_S) -> tuple:
    """A scheduler of ``m`` buckets whose items weigh ``(e, l)`` (the
    predicted durations fixed), and its items."""
    e, l = np.asarray(e, np.float64), np.asarray(l, np.float64)
    sched = OnlineMicrobatchScheduler(
        ParallelismPlan(llm=ModuleParallelism(1, 1, 1), n_mb=m), None, 1,
        ilp_time_limit_s=limit)
    sched.item_durations = lambda items, plan=None: (e, l)
    return sched, [DataItem(1, 1, item_id=i) for i in range(len(e))]


@pytest.fixture
def off_after():
    yield
    trace.recorder().enabled = False
    trace.recorder().clear()


def _close(sched) -> None:
    sched._pool.shutdown(wait=True)
    sched._worker.close()


def _instance(name: str) -> tuple:
    rng = np.random.default_rng(20261018)
    if name == "empty":
        return [], [], 4
    if name == "one_bucket":
        return rng.uniform(0.1, 1, 9), rng.uniform(0.1, 1, 9), 1
    if name == "lpt_at_bound":
        return np.full(8, 0.5), np.full(8, 0.75), 4
    if name == "small_exact":
        return rng.uniform(0.1, 1, 10), rng.uniform(0.1, 1, 10), 4
    if name == "past_max_exact_n":
        return rng.uniform(0.1, 1, 800), rng.uniform(0.1, 1, 800), 4
    raise ValueError(name)


@pytest.mark.parametrize("name", ["empty", "one_bucket", "lpt_at_bound", "small_exact",
                                  "past_max_exact_n"])
def test_worker_groups_equal_the_in_process_search(name):
    e, l, m = _instance(name)
    # an exact search given all the time it needs; the LPT path past
    # max_exact_n is deterministic
    limit = LIMIT_S if name == "past_max_exact_n" else 60.0
    sched, items = _scheduler(e, l, m, limit)
    want = solve_makespan_bnb(e, l, m, time_limit_s=limit)
    sched.submit(items, batch=0)
    got = sched.collect()
    assert got.groups == want.groups and got.cmax == want.cmax
    assert got.solver == ("ilp-timeout" if name == "past_max_exact_n" else "ilp")
    assert sched.schedule(items).groups == want.groups        # the thread's path
    _close(sched)


def test_worker_loads_no_torch_and_starts_once(off_after):
    e, l, m = _instance("small_exact")
    sched, items = _scheduler(e, l, m)
    with trace.recording() as rec:
        sched.submit(items, batch=0)
        sched.collect()
        worker = sched._worker
        sched.submit(items, batch=1)
        sched.collect()
        sched.schedule(items, batch=2)
    assert sched._worker is worker and worker.proc.poll() is None
    mods = worker.modules()
    assert "numpy" in mods and "repro_torch.core.scheduler.ilp" in mods
    assert not [name for name in mods if name == "torch" or name.startswith("torch.")]
    spans = [s for s in rec.spans() if s["name"] == "sched.schedule"]
    assert [(s["batch"], s["args"]["where"]) for s in spans] == \
        [(0, "worker"), (1, "worker"), (2, "thread")]
    nodes = solve_makespan_bnb(e, l, m, time_limit_s=60.0).nodes
    assert all(s["args"]["nodes"] == nodes for s in spans)
    _close(sched)


def test_worker_exits_with_its_scheduler():
    e, l, m = _instance("small_exact")
    sched, items = _scheduler(e, l, m)
    sched.submit(items)
    sched.collect()
    sched.submit(items)                 # left in flight, as a run's last prefetch
    proc = sched._worker.proc
    sched._pool.shutdown(wait=True)
    del sched
    gc.collect()
    assert proc.returncode is not None
    with pytest.raises(ProcessLookupError):
        os.kill(proc.pid, 0)


def test_worker_errors_surface_in_collect():
    e, l, m = _instance("small_exact")
    sched, items = _scheduler(e, l, m)
    sched.item_durations = lambda items, plan=None: (np.asarray(e), np.asarray(l[:3]))
    sched.submit(items)
    with pytest.raises(RuntimeError, match="ValueError"):
        sched.collect()
    assert not sched.has_pending and sched._worker.proc.poll() is None
    sched.item_durations = lambda items, plan=None: (np.asarray(e), np.asarray(l))
    sched.submit(items)
    assert sched.collect().solver == "ilp"        # the same worker answers again
    sched._worker.proc.kill()
    sched.submit(items)
    with pytest.raises(RuntimeError, match="exited"):
        sched.collect()
    _close(sched)


def _progress(running) -> float:
    """Turns a second of a loop standing in for the step's thread: a little
    Python work (packing), then the interpreter lock given up (a launch)."""
    n, t0 = 0, time.perf_counter()
    while running() and time.perf_counter() - t0 < 60.0:
        x = 0
        for i in range(50):
            x += i
        time.sleep(0)
        n += 1
    return n / (time.perf_counter() - t0)


def test_worker_search_leaves_the_interpreter_lock_to_the_step():
    rng = np.random.default_rng(1)
    e, l = rng.uniform(0.1, 1, 28), rng.uniform(0.1, 1, 28)
    sched, items = _scheduler(e, l, 4)
    sched.submit(items)
    sched.collect()                     # the worker started and warm
    # the same search on the pool's thread, as before the worker
    fut = sched._pool.submit(sched.schedule, items)
    beside_thread = _progress(lambda: not fut.done())
    assert fut.result().solver == "ilp-timeout"
    sched.submit(items)
    beside_worker = _progress(lambda: not sched._pending.done())
    assert sched.collect().solver == "ilp-timeout"
    assert beside_worker >= 2 * beside_thread, (beside_worker, beside_thread)
    _close(sched)
