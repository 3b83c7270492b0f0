"""Round-robin convergence run with a kill and a resume.

    python -m prpe_tpu_torch.tools.run_convergence [--epochs 24] [--samples 256]
        [--save-every 6] [--kill-delay 60] [--out runs/torch_convergence]
        [--data build/convergence_data] [--device cpu --preset tiny --image-size 64]

The port's counterpart of ``tools/run_convergence.py``. It writes learnable
synthetic datasets for all four tasks with ``tools/make_dataset.py`` (once,
under ``--data``), trains ``python -m prpe_tpu_torch.cli.train`` on them
(the full preset at 640^2 by default, lr 1e-3, ``--max-train-samples
--samples``, ``--max-val-samples 64``, ``--device-resident`` unless
``--no-device-resident``, ``--save-every``), and kills it with SIGKILL
``--kill-delay`` seconds after its first checkpoint appears: a kill at a
point set by the run's own progress, where the JAX tool kills on a wall
clock. It then resumes with ``--resume-checkpoint latest``, up to 3 times
(``:160-195``). Each process logs into its own directory under ``--out``
(``phase1/``, ``phase2_resume/``, ``phase2_resume1/`` ...); the merged
per-task histories (``<task>_history.csv``: each phase's rows up to the
checkpoint the next one resumed from) go to ``--out``, with
``resume.json``, which says where each phase resumed, whether it started
there, and whether every task's merged epochs run 0, 1, ... without a gap
or a repeat. ``summarize`` (``:69-125``: first-3 against last-3 epoch
means of each task's head metric, degenerate curves skipped) writes
``summary.json``. Exit 0 when every task improved and the resume checks
hold. Checkpoints go to ``--out``/ckpt. CUDA unless ``--device`` names
another.
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
import signal
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "runs" / "torch_convergence"
DEFAULT_DATA = ROOT / "build" / "convergence_data"
TASKS = ("person_detection", "face_detection", "face_recognition", "pose_estimation")


def train_cmd(args, data: pathlib.Path, out: pathlib.Path, log_dir: pathlib.Path,
              resume: bool) -> list:
    cmd = [
        sys.executable, "-m", "prpe_tpu_torch.cli.train",
        "--epochs", str(args.epochs),
        "--batch-size", str(args.batch_size),
        "--learning-rate", "1e-3",
        "--image-size", str(args.image_size),
        "--preset", args.preset,
        "--person-data-dir", str(data / "person"),
        "--face-data-dir", str(data / "face"),
        "--face-rec-data-dir", str(data / "faces"),
        "--pose-data-dir", str(data / "pose"),
        "--max-train-samples", str(args.samples),
        "--max-val-samples", str(args.val_samples),
        "--checkpoint-dir", str(out / "ckpt"),
        "--log-dir", str(log_dir),
        "--component-dir", str(out / "no_components"),  # fresh init
        "--save-every", str(args.save_every),
    ]
    if args.device_resident:
        cmd += ["--device-resident"]
    if args.device:
        cmd += ["--device", args.device]
    if resume:
        cmd += ["--resume-checkpoint", "latest"]
    return cmd


def summarize(out: pathlib.Path) -> dict:
    """First-3 against last-3 epoch means of each task's head metric."""
    heads = {
        "person_detection": ["val/mAP50", "val/mAP50-95"],
        "face_detection": ["val/mAP50", "val/mAP50-95"],
        "face_recognition": ["val/acc"],
        # not val/pck: it compares normalised distances with a pixel
        # threshold (kept from the reference) and saturates at 1.0
        "pose_estimation": ["val/kpt_AP", "val/kpt_AP50", "val/pck_px"],
    }
    summary = {}
    for task, prefs in heads.items():
        path = out / f"{task}_history.csv"
        if not path.exists():
            summary[task] = {"error": f"missing {path.name}"}
            continue
        rows = list(csv.DictReader(path.open()))
        cols = list(rows[0].keys())

        def curve(col):
            return [float(r[col]) for r in rows if r.get(col) not in (None, "")]

        # the first head metric that is not degenerate (a total range over
        # 0.01), else any such val/ metric (val/loss last: lower is better)
        def meaningful(c):
            vals = curve(c)
            return len(vals) > 1 and (max(vals) - min(vals)) > 0.01

        col = next((c for c in prefs + [c for c in cols if c.startswith("val/")]
                    if c in cols and meaningful(c)), None)
        if col is None:
            summary[task] = {"error": "no non-constant val metric"}
            continue
        vals = curve(col)
        head = sum(vals[:3]) / max(len(vals[:3]), 1)
        tail = sum(vals[-3:]) / max(len(vals[-3:]), 1)
        loss = curve("val/loss") if "val/loss" in cols else []
        up_is_good = "loss" not in col
        summary[task] = {
            "metric": col, "epochs": len(vals),
            "first3_mean": round(head, 4), "last3_mean": round(tail, 4),
            "improved": bool(tail > head if up_is_good else tail < head),
            "val_loss_first3": round(sum(loss[:3]) / 3, 4) if len(loss) >= 3 else None,
            "val_loss_last3": round(sum(loss[-3:]) / 3, 4) if len(loss) >= 3 else None,
            "curve": [round(v, 4) for v in vals],
        }
    return summary


def _key(task: str, row: dict):
    return int(float(row["epoch"])), TASKS.index(task)


def merge_histories(phases, out: pathlib.Path, epochs: int) -> dict:
    """Each phase's ``<task>_history.csv`` rows, in order; a phase that
    resumed from the checkpoint (epoch e, last task t) first drops the rows
    after (e, t), which it runs again. Writes the merged CSVs to ``out``
    and returns the resume checks."""
    merged = {t: [] for t in TASKS}
    checks = {"resumed_from_saved_epoch": True, "phases": []}
    for ph in phases:
        point = ph.get("resumed_from")
        rows = {}
        for task in TASKS:
            path = pathlib.Path(ph["dir"]) / f"{task}_history.csv"
            rows[task] = [r for r in csv.DictReader(path.open()) if r.get("epoch")] \
                if path.exists() else []
        starts = {t: _key(t, r[0])[0] for t, r in rows.items() if r}
        if point is not None:
            cut = (int(point["epoch"]), TASKS.index(point["last_task"]))
            for task in TASKS:
                merged[task] = [r for r in merged[task] if _key(task, r) <= cut]
            # the next task of the saved epoch, then the next epoch
            want = {t: cut[0] + (TASKS.index(t) <= cut[1]) for t in starts}
            if starts != want:
                checks["resumed_from_saved_epoch"] = False
        for task in TASKS:
            merged[task] += rows[task]
        checks["phases"].append({"log": ph["log"], "rc": ph["rc"], "resumed_from": point,
                                 "first_epoch_per_task": starts})
    contiguous = {}
    for task, task_rows in merged.items():
        if not task_rows:
            continue
        fields = list(dict.fromkeys(k for r in task_rows for k in r))
        with (out / f"{task}_history.csv").open("w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            w.writerows(task_rows)
        contiguous[task] = [_key(task, r)[0] for r in task_rows] == list(range(epochs))
    checks["contiguous"] = contiguous
    checks["ok"] = bool(checks["resumed_from_saved_epoch"] and contiguous
                        and all(contiguous.values()) and len(phases) > 1
                        and phases[-1]["rc"] == 0)
    return checks


def _first_checkpoint(ckpt_dir: pathlib.Path, proc: subprocess.Popen):
    """Seconds until the first ``epoch*.pt`` is complete, or None when the
    process ends first."""
    t0 = time.perf_counter()
    while proc.poll() is None:
        if any(ckpt_dir.glob("epoch*.pt")):
            return time.perf_counter() - t0
        time.sleep(0.2)
    return None


def _latest(ckpt_dir: pathlib.Path):
    """The checkpoint ``--resume-checkpoint latest`` restores (its meta
    entry), or None."""
    from prpe_tpu_torch.train.checkpoint import CheckpointManager

    found = CheckpointManager(str(ckpt_dir)).latest()
    return None if found is None else {"epoch": found[1].get("epoch"),
                                       "last_task": found[1].get("last_task")}


def run(args) -> int:
    from prpe_tpu_torch.core.device import resolve_device

    data, out = pathlib.Path(args.data), pathlib.Path(args.out)
    resume_ok = True  # --summarize-only judges the histories alone
    if not args.summarize_only:
        resolve_device(args.device)  # no GPU and no --device: raise here, not in the trainer
        out.mkdir(parents=True, exist_ok=True)
        if not (data / "pose" / "annotations").exists():
            from prpe_tpu_torch.tools.make_dataset import make_dataset

            make_dataset(data, args.samples, args.val_samples)
        phases = []

        def phase(log: str, resume: bool) -> subprocess.Popen:
            d = out / log
            d.mkdir(parents=True, exist_ok=True)
            point = _latest(out / "ckpt") if resume else None
            phases.append({"log": log, "dir": str(d), "resumed_from": point, "rc": None})
            return subprocess.Popen(train_cmd(args, data, out, d, resume), cwd=ROOT,
                                    stdout=(out / f"{log}.log").open("w"),
                                    stderr=subprocess.STDOUT)

        print(f"[convergence] phase 1: training, SIGKILL {args.kill_delay} s after the first "
              "checkpoint", flush=True)
        p = phase("phase1", resume=False)
        t_ckpt = _first_checkpoint(out / "ckpt", p)
        killed = False
        if t_ckpt is not None:
            try:
                p.wait(timeout=args.kill_delay)
            except subprocess.TimeoutExpired:
                p.send_signal(signal.SIGKILL)
                killed = True
        phases[-1]["rc"] = p.wait()
        if not killed:
            print("[convergence] finished before the kill", flush=True)
        else:
            print(f"[convergence] killed {args.kill_delay} s after the first checkpoint "
                  f"({t_ckpt:.1f} s in); resuming from latest", flush=True)
            for attempt in range(3):
                log = "phase2_resume" + ("" if attempt == 0 else str(attempt))
                p = phase(log, resume=_latest(out / "ckpt") is not None)
                try:
                    phases[-1]["rc"] = p.wait(timeout=args.resume_timeout)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    phases[-1]["rc"] = "timeout"
                if phases[-1]["rc"] == 0:
                    break
                print(f"[convergence] resume attempt {attempt} failed (rc={phases[-1]['rc']}, "
                      f"see {log}.log); retrying", flush=True)
        resume = merge_histories(phases, out, args.epochs)
        resume.update(killed=killed, first_checkpoint_s=t_ckpt, kill_delay_s=args.kill_delay)
        (out / "resume.json").write_text(json.dumps(resume, indent=2))
        resume_ok = resume["ok"]

    summary = summarize(out)
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "curve"}
                      for k, v in summary.items()}, indent=2))
    ok = all(v.get("improved") for v in summary.values())
    print(f"[convergence] all tasks improved: {ok}; resume checks: {resume_ok}")
    return 0 if ok and resume_ok else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--samples", type=int, default=256, help="train samples per task")
    ap.add_argument("--val-samples", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--preset", choices=("full", "tiny"), default="full")
    ap.add_argument("--data", default=str(DEFAULT_DATA))
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--kill-delay", type=float, default=60.0,
                    help="seconds after the first checkpoint appears before the SIGKILL")
    ap.add_argument("--no-device-resident", dest="device_resident", action="store_false")
    ap.add_argument("--save-every", type=int, default=6)
    ap.add_argument("--resume-timeout", type=int, default=3600,
                    help="seconds a resume attempt may take before it is killed and retried")
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--device", default=None, help="torch device of the trainer (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
