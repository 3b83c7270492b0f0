"""The port's convergence harness (``prpe_tpu_torch/tools/run_convergence.py``,
``run_face_validation.py``) and the training CLI's ``--tasks`` on the CPU.

- ``summarize`` of both tools equals the JAX tools' on the committed
  histories of ``runs/r3_*``, ``runs/r4_*`` and ``runs/r5_*``.
- The merge of the phases' histories drops the rows a resume runs again,
  and its checks catch a gap, a repeat and a resume at the wrong epoch.
- A kill and a resume of the tiny preset (64^2, batch 2) yield one row an
  epoch for every task.
- ``cli/train.py --tasks face_recognition --num-workers 2`` forks the
  workers of that task's loader only, and none outlive the run.
"""

import csv
import importlib.util
import json
import multiprocessing
import pathlib
import shutil
import sys

import pytest

from prpe_tpu_torch.cli import train as cli_train
from prpe_tpu_torch.tools import run_convergence as prc
from prpe_tpu_torch.tools import run_face_validation as pfv
from prpe_tpu_torch.tools.make_dataset import make_dataset
from torch_one_thread import torch_on_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ("--device", "cpu", "--preset", "tiny", "--image-size", "64", "--batch-size", "2")


def jax_tool(name):
    """A JAX-side script of ``tools/`` as a module (they import no JAX at
    module level)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    make_dataset(d, 8, 4, det_size=64, pose_size=64, face_size=32, identities=2,
                 per_identity=20)
    return d


@pytest.mark.parametrize("run", ["r3_round_robin_convergence", "r4_round_robin_convergence",
                                 "r5_round_robin_convergence"])
def test_summarize_equals_the_jax_tool(run):
    out = ROOT / "runs" / run
    want = jax_tool("run_convergence").summarize(out)
    assert prc.summarize(out) == want
    assert set(want) == set(prc.TASKS)
    if run.startswith("r5"):  # every head metric, each improved
        assert all(v["improved"] for v in want.values())
    if run.startswith("r3"):  # the error paths: missing files, constant curves
        assert all("error" in v for v in want.values())


def test_summarize_only_reproduces_the_jax_summary(tmp_path):
    """``--summarize-only`` over the JAX run's histories writes the JAX
    run's own ``summary.json``."""
    run = ROOT / "runs" / "r5_round_robin_convergence"
    for csv_path in run.glob("*_history.csv"):
        shutil.copy(csv_path, tmp_path)
    assert prc.main(["--summarize-only", "--out", str(tmp_path)]) == 0
    assert json.loads((tmp_path / "summary.json").read_text()) == json.loads(
        (run / "summary.json").read_text())


def test_face_validation_summary_equals_the_jax_tool(tmp_path, monkeypatch):
    src = ROOT / "runs" / "r5_face_validation" / "face_recognition_history.csv"
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        shutil.copy(src, tmp_path / name)
    monkeypatch.setattr(sys, "argv", ["run_face_validation.py", "--summarize-only",
                                      "--out", str(tmp_path / "jax")])
    assert jax_tool("run_face_validation").main() == 0
    assert pfv.main(["--summarize-only", "--out", str(tmp_path / "port")]) == 0
    got = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "summary.json").read_text())
    assert got == json.loads((ROOT / "runs" / "r5_face_validation" / "summary.json").read_text())


def _phase(root, name, rows, rc=0, resumed_from=None):
    """A phase directory with ``rows[task] = [epoch, ...]``."""
    d = root / name
    d.mkdir()
    for task, epochs in rows.items():
        with (d / f"{task}_history.csv").open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["epoch", "val/loss"])
            w.writeheader()
            w.writerows({"epoch": e, "val/loss": f"{1.0 / (e + 1):.6f}"} for e in epochs)
    return {"log": name, "dir": str(d), "rc": rc, "resumed_from": resumed_from}


def test_merge_histories(tmp_path):
    """Killed during epoch 2 after the checkpoint (1, face_detection): the
    rows after it are dropped and run again."""
    p1 = _phase(tmp_path, "phase1", {"person_detection": [0, 1, 2], "face_detection": [0, 1, 2],
                                     "face_recognition": [0, 1], "pose_estimation": [0, 1]},
                rc=-9)
    p2 = _phase(tmp_path, "phase2", {"person_detection": [2, 3], "face_detection": [2, 3],
                                     "face_recognition": [1, 2, 3],
                                     "pose_estimation": [1, 2, 3]},
                resumed_from={"epoch": 1, "last_task": "face_detection"})
    out = tmp_path / "out"
    out.mkdir()
    checks = prc.merge_histories([p1, p2], out, 4)
    assert checks["ok"] and checks["resumed_from_saved_epoch"]
    assert checks["contiguous"] == dict.fromkeys(prc.TASKS, True)
    for task in prc.TASKS:
        rows = list(csv.DictReader((out / f"{task}_history.csv").open()))
        assert [int(r["epoch"]) for r in rows] == [0, 1, 2, 3]

    # a resume that starts a task an epoch late leaves a gap
    p2 = _phase(tmp_path, "late", {"person_detection": [2, 3], "face_detection": [2, 3],
                                   "face_recognition": [2, 3], "pose_estimation": [1, 2, 3]},
                resumed_from={"epoch": 1, "last_task": "face_detection"})
    checks = prc.merge_histories([p1, p2], out, 4)
    assert not checks["resumed_from_saved_epoch"] and not checks["ok"]
    assert checks["contiguous"]["face_recognition"] is False
    # without the resume point nothing is dropped: epochs repeat
    p2 = _phase(tmp_path, "fresh", {"person_detection": [2, 3], "face_detection": [2, 3],
                                    "face_recognition": [1, 2, 3],
                                    "pose_estimation": [1, 2, 3]})
    checks = prc.merge_histories([p1, p2], out, 4)
    assert checks["contiguous"]["person_detection"] is False and not checks["ok"]


def test_kill_and_resume_of_the_tiny_preset(tiny_data, tmp_path, monkeypatch):
    """SIGKILL right after the first checkpoint (epoch 0, person detection),
    then ``--resume-checkpoint latest``: each task's merged history holds
    epochs 0 and 1 once, and the resumed process started at the next task."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the trainers share the host with the suite
    out = tmp_path / "out"
    try:
        prc.main([*TINY, "--samples", "4", "--val-samples", "4", "--epochs", "2",
                  "--save-every", "1", "--kill-delay", "0", "--data", str(tiny_data),
                  "--out", str(out)])
    finally:  # half a GB a checkpoint, even at the tiny preset
        shutil.rmtree(out / "ckpt", ignore_errors=True)
    resume = json.loads((out / "resume.json").read_text())
    assert resume["killed"] and resume["ok"], resume
    assert [p["log"] for p in resume["phases"]] == ["phase1", "phase2_resume"]
    assert resume["phases"][0]["rc"] != 0 and resume["phases"][1]["rc"] == 0
    assert resume["phases"][1]["resumed_from"]["epoch"] == 0
    for task in prc.TASKS:
        rows = list(csv.DictReader((out / f"{task}_history.csv").open()))
        assert [int(float(r["epoch"])) for r in rows] == [0, 1], task
    summary = json.loads((out / "summary.json").read_text())
    assert set(summary) == set(prc.TASKS)


def test_face_validation_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "out"
    # 2 x 20 crops: 36 train (9 steps of 4) and one val batch of 4
    try:
        pfv.main([*TINY, "--batch-size", "4", "--ids", "2", "--per-id", "20", "--epochs", "1",
                  "--data", str(tmp_path / "faces"), "--out", str(out)])
    finally:
        shutil.rmtree(out / "ckpt", ignore_errors=True)
    summary = json.loads((out / "summary.json").read_text())
    assert summary["epochs"] == 1 and len(summary["acc_curve"]) == 1
    assert summary["val_ver_acc_last3"] is not None
    assert set(summary["checks"]) == {"val_acc_rises", "margin_metric_below_fixed",
                                      "verification_above_chance"}


def test_tasks_builds_only_the_kept_loaders(tiny_data, tmp_path, monkeypatch):
    """Every task has a dataset on disk, so each of their train loaders
    would fork 2 workers; with ``--tasks face_recognition`` only its own 2
    are alive during the run, and none after it."""
    from prpe_tpu_torch.train.round_robin import RoundRobinTrainer

    alive = []
    train = RoundRobinTrainer.train

    def watched(self, *a, **kw):
        alive.append(len(multiprocessing.active_children()))
        return train(self, *a, **kw)

    monkeypatch.setattr(RoundRobinTrainer, "train", watched)
    before = len(multiprocessing.active_children())
    argv = [*TINY, "--epochs", "1", "--tasks", "face_recognition", "--num-workers", "2",
            "--max-train-samples", "4", "--max-val-samples", "4", "--save-every", "2",
            "--person-data-dir", str(tiny_data / "person"),
            "--face-data-dir", str(tiny_data / "face"),
            "--face-rec-data-dir", str(tiny_data / "faces"),
            "--pose-data-dir", str(tiny_data / "pose"),
            "--component-dir", str(tmp_path / "none"), "--checkpoint-dir", str(tmp_path / "ck"),
            "--log-dir", str(tmp_path / "log")]
    try:
        assert cli_train.main(argv) == 0
    finally:
        shutil.rmtree(tmp_path / "ck", ignore_errors=True)
    assert alive == [before + 2]
    assert len(multiprocessing.active_children()) == before
    assert sorted(p.name for p in (tmp_path / "log").glob("*_history.csv")) == [
        "face_recognition_history.csv"]
    # every task built: 4 train loaders of 2 workers each
    args = cli_train.parse_args(argv)
    loaders = cli_train.build_task_loaders(args, cli_train.model_config(args))
    try:
        assert list(loaders) == list(prc.TASKS)
        assert len(multiprocessing.active_children()) == before + 8
        kept = cli_train.build_task_loaders(args, cli_train.model_config(args),
                                            tasks=["pose_estimation"])
        cli_train.close_loaders(kept)
        assert list(kept) == ["pose_estimation"]
    finally:
        cli_train.close_loaders(loaders)
    assert len(multiprocessing.active_children()) == before
