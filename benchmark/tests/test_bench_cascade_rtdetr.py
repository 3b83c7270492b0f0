"""The RT-DETR cascade driver and its reference on the CPU at a tiny size in
fp32: the program agrees with the reference on every judged number, the
control (the reference in float8 in the program's place) does not, and the
readers of the program's spans read the traced run (those of the device's
trace read nothing on the CPU)."""

import copy
import json

import pytest
import torch

from benchmark import control, harness
from benchmark.reference.judge_rtdetr import NUMBERS
from conftest import REPO, TINY_CONFIG, TINY_TRAFFIC, add_cell, make_root

CPU = torch.device("cpu")
CELL = "tiny_rtdetr.cascade"


def tiny_rtdetr_root(path):
    root = make_root(path)
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg.update(name="tiny_rtdetr", driver="cascade_rtdetr")
    cfg["rtdetr"] = {"num_classes": 3, "person_label": 0, "hidden": 32, "num_queries": 24,
                     "heads": 2, "ffn": 64, "num_decoder_layers": 2, "levels": 3, "points": 2,
                     "feat_strides": [8, 16, 32]}
    cfg["init"].update(rtdetr_score_gain=1.0, rtdetr_score_bias=-2.0, rtdetr_box_gain=4.0,
                       rtdetr_person_quantile=0.9,
                       rtdetr_backbone_bn_bias=[0.2, 0.4], rtdetr_residual_bn_weight=[0.02, 0.05])
    traffic = copy.deepcopy(TINY_TRAFFIC)
    traffic.update(name=CELL, config="tiny_rtdetr")
    traffic["limits"] = {k: (0 if k == "structure" else 1e-3) for k in NUMBERS}
    add_cell(root, cfg, traffic, like="cascade_rtdetr.b128")
    return root


@pytest.fixture(scope="module")
def rtdetr_root(tmp_path_factory):
    return tiny_rtdetr_root(tmp_path_factory.mktemp("rtdetr") / "checkout")


def test_program_matches_reference_and_readers_read(rtdetr_root):
    out = harness.run(CELL, 2**31 + 19, 0.3, True, root=rtdetr_root, device=CPU,
                      dtype=torch.float32)
    assert out["correct"], out["check"]
    assert set(out["check"]) == set(NUMBERS)
    assert all(out["check"][k]["value"] is not None for k in NUMBERS), out["check"]
    metrics = json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
    # host_us_per_launch divides by the trace's kernel launches, which the
    # CPU's trace has none of (test_bench_program_trace.py reads it there)
    program = {m["name"] for m in metrics if "cascade_rtdetr.b128" in m.get("workloads", [])
               and m["source"] in ("program_span", "program_counter")
               and m["name"] != "host_us_per_launch.cascade"}
    assert sum(name.endswith(".cascade_rtdetr") for name in program) == 4
    assert program <= set(out["metrics"]), program - set(out["metrics"])


def test_the_control_is_not_correct(rtdetr_root):
    rows = control.readings(CELL, [2**31 + 17], "control", root=rtdetr_root, device=CPU,
                            dtype=torch.float32)
    worse = [k for k in NUMBERS if k != "structure" and rows[0][k] is not None
             and rows[0][k] > 1e-3]
    assert {"sel_gap", "dec_err"} & set(worse), rows
