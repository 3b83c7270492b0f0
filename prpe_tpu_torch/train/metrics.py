"""Metric aggregation and the logging sinks (``prpe_tpu/train/metrics.py``):
console plus ``thesis.log`` logging, the sectioned ``training_metrics.log``
and a per-task CSV history in the JAX package's file formats, and an
optional Weights & Biases sink per task (a no-op without a project or
without ``wandb``).
"""

from __future__ import annotations

import csv
import logging
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


class AverageMeter:
    """Running mean of the values seen, NaNs skipped."""

    def __init__(self):
        self.num = 0
        self.sum = 0.0
        self.avg = 0.0

    def update(self, v, n=1):
        v = float(v)
        if not math.isnan(v):
            self.num += n
            self.sum += v * n
            self.avg = self.sum / self.num


class MetricTracker:
    """Accumulates per-step metric dicts into epoch means."""

    def __init__(self):
        self._meters: Dict[str, AverageMeter] = {}

    def update(self, metrics: Dict[str, Any], n: int = 1):
        for k, v in metrics.items():
            self._meters.setdefault(k, AverageMeter()).update(np.asarray(v), n)

    def means(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self._meters.items()}



def setup_logging(log_dir: Optional[str] = None, name: str = "prpe_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(log_dir) / "thesis.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class WandbSink:
    """Optional Weights & Biases logging, one project per task. No-ops when
    wandb is unavailable or offline."""

    def __init__(self, project: str, run_name: Optional[str] = None, config=None):
        self._run = None
        try:
            import wandb  # type: ignore

            self._run = wandb.init(project=project, name=run_name, config=config,
                                   reinit=True)
        except Exception:
            self._run = None

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        if self._run is not None:
            try:
                self._run.log(metrics, step=step)
            except Exception:
                pass

    def finish(self):
        if self._run is not None:
            try:
                self._run.finish()
            except Exception:
                pass


class MetricsLogger:
    """Sectioned metrics file + CSV history."""

    def __init__(self, log_dir: str):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "training_metrics.log"

    def log_epoch(self, epoch: int, task: str, metrics: Dict[str, float]):
        train = {k: v for k, v in metrics.items() if k.startswith("train")}
        val = {k: v for k, v in metrics.items() if k.startswith("val")}
        other = {k: v for k, v in metrics.items() if k not in train and k not in val}
        with self.path.open("a") as f:
            f.write(f"\n=== epoch {epoch} task {task} "
                    f"({time.strftime('%Y-%m-%d %H:%M:%S')}) ===\n")
            for section, d in (("train", train), ("val", val), ("other", other)):
                if not d:
                    continue
                f.write(f"[{section}]\n")
                for k in sorted(d):
                    f.write(f"  {k}: {d[k]:.6f}\n")

        csv_path = self.dir / f"{task}_history.csv"
        exists = csv_path.exists()
        with csv_path.open("a", newline="") as f:
            keys = ["epoch"] + sorted(metrics)
            w = csv.DictWriter(f, fieldnames=keys, extrasaction="ignore")
            if not exists:
                w.writeheader()
            w.writerow({"epoch": epoch, **{k: f"{v:.6f}" for k, v in metrics.items()}})
