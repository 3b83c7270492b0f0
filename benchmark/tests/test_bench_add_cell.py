"""A cell and a per-layer metric added as files run without an edit to any
file the benchmark already has; the harness end to end on the CPU."""

import json

import pytest
import torch

from benchmark import harness

CALLS_READER = '''def read(summary, ctx):
    return float(summary["calls"])
'''


def test_new_cell_and_metric_run_as_files(tiny_root):
    before = {p: p.read_bytes() for p in (tiny_root / "benchmark").rglob("*")
              if p.is_file() and "tiny" not in p.name}
    (tiny_root / "benchmark" / "metrics" / "traced_calls.tiny.py").write_text(CALLS_READER)
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({"name": "traced_calls.tiny", "unit": "calls",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "host dispatch", "moves": "cascade_images_per_s",
                                  "workloads": ["tiny.cascade"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    traced = harness.run("tiny.cascade", 2**31 + 5, 0.5, True, root=tiny_root,
                         device=torch.device("cpu"), dtype=torch.float32)
    assert traced["metrics"]["traced_calls.tiny"] == {"value": 2.0, "unit": "calls"}
    assert traced["correct"] and traced["device"]["window_s"] > 0
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    plain = harness.run("tiny.cascade", 2**31 + 6, 0.5, False, root=tiny_root,
                        device=torch.device("cpu"), dtype=torch.float32)
    assert plain["correct"] and plain["attempted"] >= 1
    assert set(plain["metrics"]) == {"cascade_images_per_s", "cascade_call_p95_ms",
                                     "peak_device_gib", "setup_s"}
    assert list(plain)[-1] == "check"
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_unknown_cell_is_refused(tiny_root):
    with pytest.raises(SystemExit):
        harness.load_cell(tiny_root, "no.such.cell")


def test_no_card_exits_without_result(tiny_root, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        harness.run("tiny.cascade", 1, 0.5, False, root=tiny_root)
    assert e.value.code == 2 and capsys.readouterr().out == ""
