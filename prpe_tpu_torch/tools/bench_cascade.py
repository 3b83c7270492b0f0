"""Face-gated pose cascade throughput on one card: the port's ``bench.py``
(``bench.py:68-211``).

    python -m prpe_tpu_torch.tools.bench_cascade [--baseline FILE] [--device DEV]
    python -m prpe_tpu_torch.tools.bench_cascade --dry-run

Prints exactly one JSON line on stdout::

    {"metric": "face_gated_pose_cascade_640_throughput", "value": N,
     "unit": "images/sec", "vs_baseline": N or null}

and one progress line a phase on stderr. The geometry is ``bench.py``'s:
batch ``PRPE_BENCH_BATCH`` (default 128), ``pose_capacity`` = batch, 640^2
images and compute in bf16 (fp32 parameters), random weights from seed 0,
a gallery of 32 unit vectors, ``CascadeConfig(max_persons=8, max_faces=8,
match_threshold=0.3)`` with the default ``conf_threshold`` of 0.25. One
warm-up call, then 20 calls in chunks of 4, the card synchronised at the
end of each chunk; once ``PRPE_BENCH_DEADLINE_S`` (default 480) seconds
have passed since the start, the line is made from the chunks done.
``PRPE_ATTN_MODE`` picks the ViT's attention: the default runs K1 (NMS)
and K2 (packed MHSA), ``pallas_lnfused`` K1 and K4.

Departures from ``bench.py``:

- ``vs_baseline`` divides by ``cascade_composite_img_per_sec`` of the JSON
  that ``bench_reference_torch`` wrote on the same card (``--baseline
  FILE``); without that file it is null and stderr says why.
  ``bench.py``'s 0.6869 is a host-CPU figure of another machine.
- ``--dry-run`` runs ``bench.py``'s tiny geometry (batch 2 of 128^2, 64
  NMS candidates, IR-18, a 1-layer ViT of width 32 on 64x48 crops, 4
  persons and faces, a gallery of 4, 4 timed calls one by one) on the CPU
  in fp32, in this process: the port has no TPU relay to escape, so it
  does not re-exec itself.
- No backend probe: without a card the run stops at once with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from prpe_tpu_torch.tools.timing import card, emit, log, sync

METRIC = "face_gated_pose_cascade_640_throughput"


def _log(msg: str) -> None:
    log("bench_cascade", msg)


def baseline_rate(path) -> float | None:
    """The composite images/s in ``bench_reference_torch``'s JSON at
    ``path``, or None (with the reason on stderr)."""
    if path is None:
        _log("vs_baseline is null: no --baseline file (bench_reference_torch's JSON, "
             "measured on this card)")
        return None
    if not os.path.exists(path):
        _log(f"vs_baseline is null: {path} does not exist")
        return None
    with open(path) as f:
        data = json.load(f)
    return float(data["cascade_composite_img_per_sec"])


def run(args) -> dict:
    """The measurement: -> the stdout record plus ``calls`` (warm-up
    included), ``batch``, ``device``, ``card`` and ``attn_mode`` for a
    caller in the same process."""
    from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner

    t_start = time.perf_counter()
    deadline_s = float(os.environ.get("PRPE_BENCH_DEADLINE_S", "480"))
    device = resolve_device("cpu" if args.dry_run else args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.dry_run:
        batch, size, gallery_size = 2, 128, 4
        model = CascadeModel(
            DetectionConfig(pre_nms_top_k=64),
            PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                       vit_layers=1, vit_heads=2),
            irnet_layers=18, dtype=dtype, device=device, seed=0)
        cfg = CascadeConfig(max_persons=4, max_faces=4, match_threshold=0.3)
        target, chunk = 4, 1
    else:
        batch = int(os.environ.get("PRPE_BENCH_BATCH", "128"))
        size, gallery_size = 640, 32
        _log(f"device={device} dtype={str(dtype).replace('torch.', '')} batch={batch}; "
             "building the model...")
        model = CascadeModel(DetectionConfig(), PoseConfig(), dtype=dtype, device=device, seed=0)
        cfg = CascadeConfig(max_persons=8, max_faces=8, match_threshold=0.3)
        target, chunk = 20, 4
    runner = build_cascade_runner(model, cfg, pose_capacity=batch, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.rand(batch, size, size, 3, generator=gen, device=device).to(dtype)
    gallery = torch.nn.functional.normalize(
        torch.randn(gallery_size, 512, generator=gen, device=device), dim=-1)

    out = runner(images, gallery)
    sync(device)
    calls = 1
    _log("warm-up call done; measuring...")
    done = 0
    t0 = time.perf_counter()
    while done < target:
        for _ in range(chunk):
            out = runner(images, gallery)
        sync(device)
        done += chunk
        _log(f"measured {done}/{target} calls "
             f"({batch * done / (time.perf_counter() - t0):.0f} img/s)")
        if time.perf_counter() - t_start > deadline_s:
            _log(f"soft deadline {deadline_s:.0f} s passed: the result is from {done} calls")
            break
    rate = batch * done / (time.perf_counter() - t0)
    calls += done
    if not bool(torch.isfinite(out.pose_keypoints).all()):
        raise RuntimeError("bench_cascade: the cascade returned non-finite keypoints")
    base = baseline_rate(args.baseline)
    record = {"metric": METRIC, "value": round(rate, 2), "unit": "images/sec",
              "vs_baseline": None if base is None else round(rate / base, 3)}
    return {"record": record, "calls": calls, "batch": batch, "device": str(device),
            "card": card(device), "attn_mode": os.environ.get("PRPE_ATTN_MODE", "pallas_packed")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="bench.py's tiny geometry on the CPU")
    ap.add_argument("--baseline", default=None,
                    help="bench_reference_torch's JSON from this card (for vs_baseline)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    result = run(parse_args(argv))
    _log(f"card: {result['card']}; attention mode {result['attn_mode']}; "
         f"{result['calls']} calls")
    emit(result["record"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
