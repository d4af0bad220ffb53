"""The control and the planted faults come out not correct against a cell's
own limits, and a sound run comes out correct: at tiny sizes on the CPU,
through the whole of a run but the harness's look for a card.  (On the card
at the cells' own sizes: ``portbench/control.py``, PERF.md section 2.)"""
import pytest

import tiny
from portbench import control, core

DRV = core.load_module("drivers", "dflop_train")
WORKLOADS = [w["name"] for w in core.benchmark()["workloads"]]


def _correct(rec, cell):
    ok, _ = core.judge(rec["checks"], cell["limits"])
    return ok and rec["failed"] == 0 and rec["attempted"] > 0


def test_a_sound_run_is_correct():
    cell = tiny.cell()
    rec = DRV.run(cell, 2 ** 31 + 1, 0.5, False, device="cpu")
    assert _correct(rec, cell), rec["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_decay", "ascent"])
def test_a_broken_step_is_not_correct(fault):
    cell = tiny.cell()
    rec = DRV.run(cell, 2 ** 31 + 2, 0.5, False, device="cpu", fault=fault)
    assert not _correct(rec, cell), rec["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_is_not_correct(workload):
    cell = tiny.cell(workload)
    rows = control.readings_for(cell, 2 ** 31 + 4, "cpu", control=True)
    prog, ctl = rows
    assert core.judge(prog["numbers"], cell["limits"])[0], prog["numbers"]
    assert not core.judge(ctl["numbers"], cell["limits"])[0], ctl["numbers"]
