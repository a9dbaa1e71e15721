"""BENCHMARK.json against the contract's form, and every cell's files found
by name."""
import json
import os
import re

import pytest

from portbench import harness

REPO = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys_and_command():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_allowed_characters(kind):
    b = _bench()
    names = [e["name"] for e in b[kind]]
    assert len(names) == len(set(names))
    for e in b[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        for key in e.get("reduced", []):
            assert NAME.match(key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_metric_keys_and_moves():
    b = _bench()
    e2e = {m["name"] for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        reporting = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        for w in m.get("workloads", cells):
            assert w in cells and w in reporting.get("workloads", cells)


@pytest.mark.parametrize("workload", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_files_by_name(workload):
    spec = harness.load_cell(workload)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["entry"]
    harness.entry_driver(spec)
    assert spec["limits"], "the cell has no limits file"
    kinds = {k: [m["name"] for m in v] for k, v in spec["metrics"].items()}
    assert "setup_s" in kinds["end_to_end"] and len(kinds["end_to_end"]) >= 2
    assert kinds["per_layer"]
    for name in kinds["end_to_end"] + kinds["per_layer"]:
        assert os.path.exists(harness.reader_path(REPO, name))
    assert spec["config"]["work"][harness.entry_driver(spec).step_kind] > 0


def test_config_files_are_theirs_and_sources_match():
    b = _bench()
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"].startswith(c["source"].split()[0])


def test_a_split_metric_reads_as_its_parent():
    assert harness.reader_path(REPO, "mfu.ite.d8").endswith(os.path.join("metrics", "mfu.ite.py"))
    assert harness.reader_path(REPO, "ite_updates_per_s.d8").endswith("ite_updates_per_s.py")
    assert harness.reader_path(REPO, "mfu.ite").endswith("mfu.ite.py")
    with pytest.raises(FileNotFoundError):
        harness.reader_path(REPO, "no_such_metric.d8")
