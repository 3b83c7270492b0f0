"""Shared set-up of the benchmark's CPU tests: the repository on ``sys.path``,
one torch thread, and ``tiny_root``: a copy of the benchmark under a
temporary checkout root with a tiny cascade cell (``tiny.cascade``) added as
files, so a test can run the harness end to end on the CPU."""

import copy
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import torch  # noqa: E402

torch.set_num_threads(1)

TINY_CONFIG = {
    "name": "tiny_cascade", "driver": "cascade", "source": "test", "reduced": [],
    "dtype": "float32", "param_dtype": "float32", "attn_mode": "pallas_packed",
    "yolo": {"variant": "n", "width": [3, 16, 32, 64, 128, 256], "depth": [1] * 6,
             "csp": [False, True], "num_classes": 1, "reg_max": 16, "image_size": 64},
    "init": {"bn_weight": [0.15, 0.25], "head_gain": 6.0},
    "irnet": {"layers": 18, "input_size": 112, "embedding_size": 512},
    "pose": {"input_size": [64, 48], "heatmap_size": [16, 12], "num_keypoints": 17,
             "hidden": 32, "layers": 1, "heads": 2, "mlp_ratio": 4, "patch_size": 16,
             "decoder_scale_factor": 4},
    "cascade": {"max_persons": 4, "max_faces": 4, "match_threshold": 0.3,
                "conf_threshold": 0.25, "iou_threshold": 0.65, "pre_nms_top_k": 64,
                "face_capacity_per_frame": 2, "pose_capacity_per_frame": 1,
                "gate_pose": True, "pose_flip_test": False},
}
TINY_TRAFFIC = {
    "name": "tiny.cascade", "config": "tiny_cascade", "chips": 1, "why": "test", "batch": 2, "pool_batches": 2, "gallery": 4,
    "planted_per_batch": 2, "calibration_frames": 2,
    "octaves": [[4, 0.3], [16, 0.3], [32, 0.2], [64, 0.2]], "trace_calls": 2, "check_calls": 2,
    "limits": {"det_err": 1e-3, "nms_gap": 1e-3, "face_gap": 1e-3, "pose_gap": 1e-3,
               "pose_score_err": 1e-3, "structure": 0, "e2e_miss": 1e-3, "e2e_box_err": 1e-3},
}


def add_cell(root: Path, config: dict, traffic: dict, like: str = "cascade.b128") -> None:
    """``config`` and ``traffic`` as files under ``root``, the cell in its
    manifest beside the others, with every metric that lists cells."""
    bench = root / "benchmark"
    (bench / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (bench / "traffic" / f"{traffic['name']}.json").write_text(json.dumps(traffic))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": traffic["name"], "config": config["name"],
                                  "traffic": traffic["name"], "chips": 1, "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append(traffic["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


def make_root(root: Path) -> Path:
    """A checkout at ``root`` holding the benchmark and the tiny cell."""
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_cell(root, copy.deepcopy(TINY_CONFIG), copy.deepcopy(TINY_TRAFFIC))
    os.environ.setdefault("PRPE_ATTN_MODE", "pallas_packed")
    return root


@pytest.fixture
def tiny_root(tmp_path):
    """A fresh checkout for a test that adds or changes files."""
    return make_root(tmp_path / "checkout")


@pytest.fixture(scope="module")
def shared_root(tmp_path_factory):
    """One checkout for the tests of a module that only read it."""
    return make_root(tmp_path_factory.mktemp("shared") / "checkout")
