"""Device time of the round-robin train steps by kernel and by module, from
``torch.profiler`` traces: the port's ``tools/profile_train.py``.

    python -m prpe_tpu_torch.tools.profile_train [batch] [image_size] [task ...]
        [--iters 3] [--device DEV]
    python -m prpe_tpu_torch.tools.profile_train --dry-run [task ...]

The reference training configuration of ``bench_train`` (default batch 32
at 640^2, bf16 with fp32 parameters, ``remat_backbone=True``, one Adam at
lr 1e-3 per task over its branch, one synthetic batch a task): each task's
step once as warm-up, then ``--iters`` steps of each task under the
profiler, one trace a task. Prints, per task, the kernel ms per step (and
images/s at that rate), the launches per step, the busy share, then the
top kernels and the kernel time per module of the model (the trunk, each
adapter and branch; the backward, the loss and the optimizer run outside
any module's forward), then one JSON line with every number. The traces
go to ``build/traces/train_<task>-<ns>.json``.

Departures from the JAX tool: one trace a task instead of one for all
(the tasks' kernels carry no step name to split them by); tables by
kernel name and by module instead of HLO category and source line;
``--dry-run`` runs the ``--preset tiny`` model of ``cli/train.py`` at 64^2
on the CPU (operator host times).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from prpe_tpu_torch.tools.dump_trace_ops import print_profile, profile_top
from prpe_tpu_torch.tools.timing import card, log, sync

ALL_TASKS = ("person_detection", "face_detection", "face_recognition", "pose_estimation")


def run(args) -> dict:
    from prpe_tpu_torch.core.config import CombinedModelConfig, OptimConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.data import synthetic
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.tools.bench_train import tiny_config
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import make_train_step, to_device, trainable_params

    device = resolve_device("cpu" if args.dry_run else args.device)
    tasks = tuple(args.tasks) or ALL_TASKS
    if args.dry_run:
        batch, size, iters, classes, boxes, persons = 2, 64, 1, 64, 4, 2
        cfg = tiny_config(size)
    else:
        batch, size, iters, classes, boxes, persons = (args.batch, args.image_size, args.iters,
                                                       1000, 16, 8)
        cfg = CombinedModelConfig(image_size=size, remat_backbone=True)
    cfg = dataclasses.replace(cfg, detection=dataclasses.replace(cfg.detection, max_gt=boxes))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = CombinedModel(cfg, dtype, device=device, seed=0)
    txs = {t: build_optimizer(OptimConfig(learning_rate=1e-3)) for t in tasks}
    state = create_train_state(model, txs, {t: trainable_params(model, t) for t in tasks})
    rng = np.random.default_rng(0)
    make = {"person_detection": lambda: synthetic.detection_batch(rng, batch, size, boxes),
            "face_detection": lambda: synthetic.detection_batch(rng, batch, size, boxes),
            "face_recognition": lambda: synthetic.face_batch(rng, batch, size, classes),
            "pose_estimation": lambda: synthetic.pose_batch(rng, batch, size, persons)}
    gen = torch.Generator(device=device).manual_seed(1)
    modules = dict(model.named_children())
    out = {}
    for t in tasks:
        step = make_train_step(model, t, txs[t], cfg)
        data = to_device(make[t](), device)
        holder = {"state": state}
        holder["state"], m = step(state, data, gen)
        sync(device)
        log("profile_train", f"{t}: warm-up loss {float(m['loss']):.4f}; profiling {iters} steps")

        def one():
            holder["state"], _ = step(holder["state"], data, gen)

        p = profile_top(one, top=args.top, iters=iters, modules=modules, name=f"train_{t}")
        state = holder["state"]
        out[t] = {"kernel_ms_per_step": p["kernel_ms"],
                  "images_per_s_kernel_bound": batch / (p["kernel_ms"] / 1e3)
                  if p["kernel_ms"] else None, **p}
    return {"tool": "profile_train", "card": card(device), "batch": batch, "image_size": size,
            "iters": iters, "tasks": out}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("positional", nargs="*", metavar="[batch [image_size]] [task ...]")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--dry-run", action="store_true", help="the tiny preset on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    numbers = [int(a) for a in args.positional if a.isdigit()]
    args.tasks = [a for a in args.positional if not a.isdigit()]
    unknown = [t for t in args.tasks if t not in ALL_TASKS]
    if unknown or len(numbers) > 2:
        ap.error(f"expected [batch [image_size]] [task ...] with tasks from {ALL_TASKS}")
    args.batch, args.image_size = (numbers + [32, 640][len(numbers):])[:2]
    return args


def main(argv=None) -> int:
    r = run(parse_args(argv))
    for t, p in r["tasks"].items():
        print(f"{t:18s} {p['kernel_ms_per_step']:8.2f} ms/step of kernels "
              f"({p['images_per_s_kernel_bound'] or 0:.0f} img/s), {p['launches']:.0f} launches")
    for t, p in r["tasks"].items():
        print()
        print_profile(f"a {t} step", p, top=len(p["top"]))
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
