"""Face-recognition training run on a synthetic identity set.

    python -m prpe_tpu_torch.tools.run_face_validation [--ids 256] [--per-id 12]
        [--epochs 20] [--out runs/torch_face_validation] [--device cpu ...]

The port's counterpart of ``tools/run_face_validation.py``. It writes
``--ids`` identities of ``--per-id`` face crops with
``tools/make_dataset.py::make_faces`` (once, under ``--data``), trains only
the face-recognition task (``python -m prpe_tpu_torch.cli.train --tasks
face_recognition``, staged on the card, one checkpoint at the end), then
checks its history CSV as the JAX tool does:

* the margin-free ``val/acc`` rises (last-3 mean over both the first-3
  mean and twice chance);
* ``val/acc_margin`` (argmax over the margin-penalised logits) ends below
  ``val/acc``;
* the k-fold verification accuracy ``val/ver_acc`` ends above 0.6.

Writes ``summary.json`` beside the CSV and exits 0 when all three hold.
CUDA unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import csv
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "runs" / "torch_face_validation"
DEFAULT_DATA = ROOT / "build" / "face_validation_data"


def summarize(out: pathlib.Path, ids: int) -> dict:
    """The JAX tool's summary and checks of ``face_recognition_history.csv``."""
    rows = list(csv.DictReader((out / "face_recognition_history.csv").open()))

    def curve(col):
        return [float(r[col]) for r in rows if r.get(col) not in (None, "")]

    acc = curve("val/acc")
    accm = curve("val/acc_margin")
    ver = curve("val/ver_acc")
    k = min(3, len(acc))
    summary = {
        "ids": ids, "epochs": len(acc),
        "val_acc_first3": round(sum(acc[:k]) / k, 4),
        "val_acc_last3": round(sum(acc[-k:]) / k, 4),
        "val_acc_margin_last3": round(sum(accm[-k:]) / k, 4),
        "val_ver_acc_first3": round(sum(ver[:k]) / k, 4) if ver else None,
        "val_ver_acc_last3": round(sum(ver[-k:]) / k, 4) if ver else None,
        "acc_curve": [round(v, 4) for v in acc],
        "acc_margin_curve": [round(v, 4) for v in accm],
        "ver_acc_curve": [round(v, 4) for v in ver],
        "checks": {},
    }
    chance = 1.0 / ids
    summary["checks"]["val_acc_rises"] = bool(
        summary["val_acc_last3"] > max(summary["val_acc_first3"], 2 * chance))
    # once the model has learned, the margin biases argmax against the true class
    summary["checks"]["margin_metric_below_fixed"] = bool(
        summary["val_acc_margin_last3"] < summary["val_acc_last3"])
    summary["checks"]["verification_above_chance"] = bool(
        ver and summary["val_ver_acc_last3"] > 0.6)
    summary["pass"] = all(summary["checks"].values())
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ids", type=int, default=256)
    ap.add_argument("--per-id", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--preset", choices=("full", "tiny"), default="full")
    ap.add_argument("--data", default=str(DEFAULT_DATA))
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--summarize-only", action="store_true")
    ap.add_argument("--device", default=None, help="torch device of the trainer (default: cuda)")
    args = ap.parse_args(argv)

    data, out = pathlib.Path(args.data), pathlib.Path(args.out)
    if not args.summarize_only:
        from prpe_tpu_torch.core.device import resolve_device

        resolve_device(args.device)  # no GPU and no --device: raise here
        out.mkdir(parents=True, exist_ok=True)
        if not (data / "imgs").exists():
            from prpe_tpu_torch.tools.make_dataset import make_faces

            make_faces(data, args.ids, args.per_id)
        cmd = [
            sys.executable, "-m", "prpe_tpu_torch.cli.train",
            "--tasks", "face_recognition",
            "--epochs", str(args.epochs),
            "--batch-size", str(args.batch_size),
            "--learning-rate", "1e-3",
            "--image-size", str(args.image_size),
            "--preset", args.preset,
            "--face-rec-data-dir", str(data),
            "--max-train-samples", str(args.ids * args.per_id),
            "--max-val-samples", "512",
            "--checkpoint-dir", str(out / "ckpt"),
            "--log-dir", str(out),
            "--component-dir", str(out / "no_components"),
            "--device-resident",
            "--save-every", str(max(args.epochs, 1)),
        ]
        if args.device:
            cmd += ["--device", args.device]
        log = out / "train.log"
        print(f"[face-validation] training ({args.ids} ids x {args.per_id}, "
              f"{args.epochs} epochs) -> {log}", flush=True)
        with log.open("w") as f:
            r = subprocess.run(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        if r.returncode != 0:
            print(log.read_text()[-3000:])
            raise SystemExit(f"training failed rc={r.returncode}")

    summary = summarize(out, args.ids)
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: v for k, v in summary.items() if not k.endswith("curve")}, indent=2))
    return 0 if summary["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
