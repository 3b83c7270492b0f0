"""``BENCHMARK.json`` against the contract's shape, and every file of every
cell, configuration and per-layer metric found by name."""

import json
import re

import pytest

from conftest import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == KEYS
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_files_found_by_name():
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        path = REPO / c["file"]
        assert path == REPO / "benchmark" / "configs" / f"{c['name']}.json"
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert (REPO / "benchmark" / "drivers" / f"{data['driver']}.py").exists()
        assert c["name"] in used
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_cells_found_by_name():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        traffic = json.loads((REPO / "benchmark" / "traffic" / f"{w['name']}.json").read_text())
        assert traffic["name"] == w["name"] == w["traffic"]
        assert traffic["config"] == w["config"] and traffic["chips"] == w["chips"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(MANIFEST["workloads"])
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(pairs) // 4)


def test_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        reports = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= reports, m["name"]
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["name"].split(".")[0], m["layer"])
    for cell in cells:
        own = [m for m in MANIFEST["end_to_end"] if cell in m.get("workloads", cells)]
        assert any(m["name"] != "setup_s" for m in own)
        assert any(cell in m.get("workloads", cells) for m in MANIFEST["per_layer"])
