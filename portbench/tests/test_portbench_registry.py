"""The harness finds each cell's configuration, mix, limits, driver, reference
and metric readers by the names in BENCHMARK.json, and the file keeps to the
benchmark contract's shape."""
import json
import re

import pytest

import tiny  # noqa: F401  (puts the repo on sys.path)
from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.benchmark()


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_by_name(w):
    c = core.cell(BENCH, w["name"])
    assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert c["config"]["name"] == w["config"] and c["traffic"]["name"] == w["traffic"]
    assert (core.HERE / "drivers" / f"{c['traffic']['driver']}.py").exists()
    assert (core.HERE / "references" / f"{c['config']['reference']}.py").exists()
    lim = c["limits"]
    assert set(lim["limits"]) | set(lim.get("not_compared", {})) >= {
        "data", "loss", "grad1", "update", "decay", "descent"}
    assert c["window_pace_s"] > 0
    assert {"setup_s"} < {m["name"] for m in BENCH["end_to_end"]}
    assert BENCH["per_layer"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    mod = core.load_module("metrics", m["name"])
    assert callable(mod.read)
    assert m["moves"] in {x["name"] for x in BENCH["end_to_end"]}
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_file_is_its_own(c):
    data = json.loads((core.ROOT / c["file"]).read_text())
    assert data["name"] == c["name"] and data["source"] == c["source"]
    assert sorted(data["reduced"]) == sorted(c["reduced"])
    assert c["file"].startswith("portbench/configs/")


def test_names_are_unique_and_every_config_is_used():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_a_new_file_is_found_by_name(tmp_path, monkeypatch):
    """A metric reader added as a file is loaded without an edit elsewhere."""
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dispatch_ms.train.py").write_text("def read(rec):\n    return 1.5\n")
    monkeypatch.setattr(core, "HERE", tmp_path)
    assert core.load_module("metrics", "dispatch_ms.train").read({}) == 1.5


def test_judge_needs_every_number_under_its_limit():
    lim = {"limits": {"a": 1.0, "b": 0}}
    assert core.judge({"a": 0.5, "b": 0.0}, lim)[0]
    assert not core.judge({"a": 1.5, "b": 0.0}, lim)[0]
    assert not core.judge({"a": float("nan"), "b": 0.0}, lim)[0]
    assert not core.judge({"c": 0.0}, lim)[0]
    assert not core.judge({"a": 0.5}, None)[0]
    skip = {"limits": {"a": 1.0}, "not_compared": {"b": "no upper reading"}}
    ok, out = core.judge({"a": 0.5, "b": 7.0}, skip)
    assert ok and out["b"] == {"value": 7.0, "limit": None}
