"""The harness's registry: ``BENCHMARK.json`` names each cell's
configuration and traffic mix, and the files are found by those names:

- ``configs/<config>.json``      the configuration as it is run;
- ``traffic/<mix>.json``          the mix's parameters, and the driver that
                                  runs it (``drivers/<driver>.py``);
- ``cells/<workload>.json``       what is the cell's own: the window's pace (its
                                  fixed number of steps) and the limits of its
                                  compared numbers;
- ``references/<name>.py``        a plain reference, named by a config;
- ``metrics/<metric>.py``         one per-layer metric's reader: ``read(rec)``
                                  returns its value or None.

A later cell, configuration, mix or metric is new files and entries only.
A metric's reader returns None in a cell where it finds nothing to read,
and the metric is left out of that cell's line.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # whole top-level module names


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    """The workload's entry with its configuration, traffic and own file."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    own = load_json("cells", workload)
    return {
        "name": workload, "chips": w["chips"],
        "config": load_json("configs", w["config"]),
        "traffic": load_json("traffic", w["traffic"]),
        "window_pace_s": own["window_pace_s"],
        "limits": own,
    }


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose whole top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in modules if m.split(".", 1)[0] in FORBIDDEN})


def judge(checks: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number at or under its
    limit.  A number the cell's file lists under ``not_compared`` (no
    control or fault reading separates it from sound runs) is reported with
    no limit and decides nothing; any other number without a limit is not
    correct."""
    out, ok = {}, True
    skip = {} if limits is None else limits.get("not_compared", {})
    for name, value in checks.items():
        limit = None if limits is None else limits["limits"].get(name)
        out[name] = {"value": value, "limit": limit}
        if name not in skip:
            ok = ok and limit is not None and value == value and value <= limit
    return ok, out
