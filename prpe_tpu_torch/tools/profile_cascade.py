"""Device time of the cascade by kernel and by module, from a
``torch.profiler`` trace: the port's ``tools/profile_cascade.py``.

    python -m prpe_tpu_torch.tools.profile_cascade [batch] [--iters 5] [--device DEV]
    python -m prpe_tpu_torch.tools.profile_cascade --dry-run

The bf16 face-gated pose cascade at ``bench_cascade``'s configuration
(640^2, pose_capacity = batch, default 128; conf_threshold 0.25) with a
zero gallery, as the JAX tool runs it: one warm-up call, then ``--iters``
calls under the profiler. Prints the card's kernel time per call, the
launches per call, the busy share (kernel time over the window's wall
time), the top kernels and the kernel time per module (the two YOLOs,
IR-Net, ViTPose; the rest, NMS and crops included, outside any module),
then one JSON line with the same numbers. The Chrome trace goes to
``build/traces/cascade_b<batch>-<ns>.json`` (``dump_trace_ops`` lists it
whole). ``PRPE_ATTN_MODE`` picks the attention, as in ``bench_cascade``.

Departures from the JAX tool: a PyTorch trace has no HLO categories or
source lines, so the tables are by kernel name and by module;
``--dry-run`` runs ``bench_cascade``'s tiny geometry on the CPU, where the
rows are operators and their host time.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from prpe_tpu_torch.tools.dump_trace_ops import print_profile, profile_top
from prpe_tpu_torch.tools.timing import card, log, sync


def run(args) -> dict:
    from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner

    device = resolve_device("cpu" if args.dry_run else args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.dry_run:
        batch, size, iters = 2, 128, 1
        model = CascadeModel(
            DetectionConfig(pre_nms_top_k=64),
            PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                       vit_layers=1, vit_heads=2),
            irnet_layers=18, dtype=dtype, device=device, seed=0)
    else:
        batch, size, iters = args.batch, 640, args.iters
        model = CascadeModel(DetectionConfig(), PoseConfig(), dtype=dtype, device=device, seed=0)
    runner = build_cascade_runner(
        model, CascadeConfig(max_persons=8, max_faces=8, match_threshold=0.3),
        pose_capacity=batch, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.rand(batch, size, size, 3, generator=gen, device=device).to(dtype)
    gallery = torch.zeros(32, 512, device=device)
    runner(images, gallery)
    sync(device)
    log("profile_cascade", f"warm-up done; profiling {iters} calls at batch {batch}")
    modules = {"person_yolo": model.person_yolo, "face_yolo": model.face_yolo,
               "irnet": model.irnet, "vitpose": model.vitpose}
    p = profile_top(lambda: runner(images, gallery), top=args.top, iters=iters,
                    modules=modules, name=f"cascade_b{batch}")
    return {"tool": "profile_cascade", "card": card(device), "batch": batch, "iters": iters,
            "kernel_ms_per_call": p["kernel_ms"], "images_per_s_kernel_bound":
            batch / (p["kernel_ms"] / 1e3) if p["kernel_ms"] else None, **p}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--dry-run", action="store_true", help="a tiny cascade on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    r = run(parse_args(argv))
    print(f"{r['card']}: {r['kernel_ms_per_call']:.2f} ms of kernels a call of {r['batch']} "
          f"images ({r['images_per_s_kernel_bound'] or 0:.0f} img/s kernel-bound)\n")
    print_profile("a cascade call", r, top=len(r["top"]))
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
