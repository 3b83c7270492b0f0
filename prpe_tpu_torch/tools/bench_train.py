"""Training throughput per task on one card: the port's ``bench_train.py``
(``bench_train.py:29-112``).

    python -m prpe_tpu_torch.tools.bench_train [--batch 32] [--size 640] [--iters 5]
    python -m prpe_tpu_torch.tools.bench_train --dry-run

The reference training configuration: the full combined model with
``remat_backbone=True`` at ``--size``^2, bf16 compute with fp32
parameters, one Adam optimizer at lr 1e-3 per task over its branch (the
trunk frozen), one synthetic batch a task from ``data/synthetic.py``
(numpy seed 0: detection with 16 boxes, face recognition over 1000
classes, pose with 8 persons), random weights from seed 0. One step a
task as warm-up, then ``--iters`` steps a task, task after task.

Prints one JSON line per task, ``{"metric": "train_step_<task>", "value":
images/s, "unit": "images/sec", "device_ms_per_step", "batch",
"image_size"}``, then ``{"metric": "train_steps_bs32_640_harmonic_summary",
"value", "unit": "images/sec (mean over tasks)"}`` (the arithmetic mean of
the four rates, as the JAX script computes it under that name).

The time is the card's: CUDA events around each task's steps, queued
behind a sleep kernel so the window opens when the card reaches it (the
JAX script sums the profiler's ``jit__step`` device times). As the JAX
script refuses a trace whose ``jit__step`` count is not 4 x iters, this
one refuses a window in which its task's optimizer did not advance by
exactly ``--iters`` updates, or another task's advanced at all.

Departure: ``--dry-run`` runs the ``--preset tiny`` model of
``cli/train.py`` (batch 2 of 64^2, 1 step a task) on the CPU in fp32; the
JAX script has no dry run.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from prpe_tpu_torch.tools.timing import Window, card, emit, log, sync

TASKS = ("person_detection", "face_detection", "face_recognition", "pose_estimation")


def _log(msg: str) -> None:
    log("bench_train", msg)


def tiny_config(size: int):
    """``cli/train.py``'s ``--preset tiny`` at ``size``^2."""
    from prpe_tpu_torch.cli import train as train_cli

    return train_cli.model_config(train_cli.parse_args(
        ["--preset", "tiny", "--image-size", str(size), "--device", "cpu"]))


def update_count(opt_state) -> int:
    """The update count of the Adam state inside a ``build_optimizer``
    chain."""
    if isinstance(opt_state, dict) and "mu" in opt_state:
        return int(opt_state["count"])
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            n = update_count(s)
            if n >= 0:
                return n
    return -1


def run(args) -> dict:
    """-> ``{"records": [the stdout lines], "launches": {task: counts over
    its timed steps}, "card", "device"}``."""
    from prpe_tpu_torch.core.config import CombinedModelConfig, OptimConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.data import synthetic
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.ops.kernels import launches
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import make_train_step, to_device, trainable_params

    device = resolve_device("cpu" if args.dry_run else args.device)
    if args.dry_run:
        batch, size, iters, classes, boxes, persons = 2, 64, 1, 64, 4, 2
        cfg = tiny_config(size)
    else:
        batch, size, iters, classes, boxes, persons = args.batch, args.size, args.iters, 1000, 16, 8
        cfg = CombinedModelConfig(image_size=size, remat_backbone=True)
    cfg = dataclasses.replace(cfg, detection=dataclasses.replace(cfg.detection, max_gt=boxes))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    _log(f"device={device} batch={batch} size={size}; building the model...")
    model = CombinedModel(cfg, dtype, device=device, seed=0)
    txs = {t: build_optimizer(OptimConfig(learning_rate=1e-3)) for t in TASKS}
    state = create_train_state(model, txs, {t: trainable_params(model, t) for t in TASKS})
    rng = np.random.default_rng(0)
    make = {"person_detection": lambda: synthetic.detection_batch(rng, batch, size, boxes),
            "face_detection": lambda: synthetic.detection_batch(rng, batch, size, boxes),
            "face_recognition": lambda: synthetic.face_batch(rng, batch, size, classes),
            "pose_estimation": lambda: synthetic.pose_batch(rng, batch, size, persons)}
    gen = torch.Generator(device=device).manual_seed(1)
    steps, batches = {}, {}
    for t in TASKS:
        steps[t] = make_train_step(model, t, txs[t], cfg)
        batches[t] = to_device(make[t](), device)
        state, m = steps[t](state, batches[t], gen)
        _log(f"warm-up {t}: loss={float(m['loss']):.4f}")
    sync(device)

    window = Window(device)
    records, counts = [], {}
    total = 0.0
    for t in TASKS:
        before = {u: update_count(state.opt_states[u]) for u in TASKS}
        seen = dict(launches)
        window.start()
        for _ in range(iters):
            state, m = steps[t](state, batches[t], gen)
        ms = window.stop() / iters
        counts[t] = {k: v - seen[k] for k, v in launches.items() if v - seen[k]}
        moved = {u: update_count(state.opt_states[u]) - before[u] for u in TASKS}
        if moved != {u: iters if u == t else 0 for u in TASKS}:
            raise RuntimeError(
                f"bench_train: the {t} window holds updates {moved}, expected {iters} of "
                f"{t} and none of the other tasks: the attribution would be wrong")
        if not np.isfinite(float(m["loss"])):
            raise RuntimeError(f"bench_train: {t} loss is {float(m['loss'])}")
        img_s = batch / (ms / 1e3)
        total += img_s
        records.append({"metric": f"train_step_{t}", "value": round(img_s, 1),
                        "unit": "images/sec", "device_ms_per_step": round(ms, 2),
                        "batch": batch, "image_size": size})
    records.append({"metric": "train_steps_bs32_640_harmonic_summary",
                    "value": round(total / len(TASKS), 1),
                    "unit": "images/sec (mean over tasks)"})
    return {"records": records, "launches": counts, "card": card(device), "device": str(device)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--iters", type=int, default=5, help="timed steps a task")
    ap.add_argument("--dry-run", action="store_true",
                    help="the tiny preset on the CPU, one step a task")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    result = run(parse_args(argv))
    _log(f"card: {result['card']}; launches per task window: {result['launches']}")
    for r in result["records"]:
        emit(r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
