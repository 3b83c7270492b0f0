"""The per-layer metrics that read the program's own spans and counters
(``benchmark/program_trace.py``), from a traced run of the tiny cell on the
CPU."""

import json
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark import trace as tr
from benchmark.program_trace import PROFILING

SPANS = ("upload_ms.cascade", "detect_stage_ms.cascade", "face_stage_ms.cascade",
         "pose_stage_ms.cascade", "runner_host_ms.cascade", "host_us_per_launch.cascade")
COUNTERS = ("face_slot_fill.cascade", "pose_slot_fill.cascade")
LAUNCHES_A_CALL = 1000  # the CPU's trace has no kernels: stand-in launches


def _traced_run(root, monkeypatch, seed):
    """A traced run of the tiny cell, with every new metric listing it and
    ``LAUNCHES_A_CALL`` kernel launches a call put in the trace's reduction
    -> (result, the driver)."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for m in manifest["per_layer"]:
        if m["name"] in SPANS + COUNTERS:
            assert m["source"] == ("program_counter" if m["name"] in COUNTERS else "program_span")
            m["workloads"].append("tiny.cascade")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    drivers = []
    load_module = harness.load_module

    def keep_driver(path, name):
        module = load_module(path, name)
        if name.startswith("bench_driver_"):
            class Kept(module.Driver):
                def release(self):
                    drivers.append(self)
                    super().release()
            module.Driver = Kept
        return module

    read_trace = tr.read_trace

    def with_launches(path):
        summary = read_trace(path)
        summary["launches"] = LAUNCHES_A_CALL * 2  # the tiny cell traces 2 calls
        return summary

    monkeypatch.setattr(harness, "load_module", keep_driver)
    monkeypatch.setattr(tr, "read_trace", with_launches)
    result = harness.run("tiny.cascade", seed, 0.5, True, root=root,
                         device=torch.device("cpu"), dtype=torch.float32)
    return result, drivers[0]


def test_program_metrics_read_the_traced_calls(tiny_root, monkeypatch):
    result, driver = _traced_run(tiny_root, monkeypatch, 2**31 + 11)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(SPANS + COUNTERS) <= set(got)
    assert result["correct"]
    for name in COUNTERS:
        assert 0.0 <= got[name] <= 100.0
    calls = len(driver.calls)
    assert calls == driver.traffic["trace_calls"] == 2
    stages = got["detect_stage_ms.cascade"] + got["face_stage_ms.cascade"] \
        + got["pose_stage_ms.cascade"]
    assert 0.0 < stages <= result["device"]["window_s"] * 1e3 / calls

    # the fill of the face slots from the driver's own answers
    used = sum(min(int(c["answers"]["face_valid"].sum()), driver.face_capacity)
               for c in driver.calls)
    assert got["face_slot_fill.cascade"] == pytest.approx(
        100.0 * used / (driver.face_capacity * calls))
    pose_used = sum(int(c["answers"]["pose_valid"].sum()) for c in driver.calls)
    assert got["pose_slot_fill.cascade"] == pytest.approx(
        100.0 * pose_used / (driver.pose_capacity * calls))

    # host us a launch: the runner's host time less the upload's, per launch
    prof = sys.modules[PROFILING]
    by_call = {}
    for r in prof.spans():
        by_call.setdefault(r["call"], {})[r["name"]] = r["host_end_ns"] - r["host_start_ns"]
    assert len(by_call) == calls
    dispatch_us = [(c["cascade.call"] - c["cascade.upload"]) / 1e3 for c in by_call.values()]
    assert got["host_us_per_launch.cascade"] == pytest.approx(
        sum(dispatch_us) / calls / LAUNCHES_A_CALL)
    assert got["runner_host_ms.cascade"] == pytest.approx(
        sum(c["cascade.call"] for c in by_call.values()) / 1e6 / calls)


def test_a_program_without_records_reads_nothing(tiny_root, monkeypatch):
    """An older program keeps no spans or counters: the new metrics are
    left out of the line, and nothing raises."""
    monkeypatch.setitem(sys.modules, PROFILING, types.ModuleType(PROFILING))
    result, _ = _traced_run(tiny_root, monkeypatch, 2**31 + 12)
    assert result["correct"]
    assert not set(SPANS + COUNTERS) & set(result["metrics"])
    assert result["metrics"]["launches_per_call.cascade"]["value"] == LAUNCHES_A_CALL
