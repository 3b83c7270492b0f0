"""The reference's component stack in eager PyTorch on one card: the
denominator of ``bench_cascade``'s ``vs_baseline`` (the port's
``tools/bench_reference_torch.py:47-86``).

    python -m prpe_tpu_torch.tools.bench_reference_torch [--batch 128] [--iters 10]
        [--out FILE] [--device DEV]

Times, in fp32 eager PyTorch with random weights, the reference's
components at full scale: YOLOv11-n at 640^2 and AdaFace IR-50 at 112^2
(the transcriptions in ``tools/reference_nets.py``) and ViTPose-B at
256x192 (``transformers``' ``VitPoseForPoseEstimation`` built from a
``VitPoseConfig``, as the JAX tool builds it; nothing is downloaded). The
cascade composite charges each image two YOLO passes (person and face),
one IR-50 embedding and one ViTPose-B crop, and leaves out the host's NMS,
crops and copies, so it favours the reference:

    cascade_composite_img_per_sec = batch / (2 t_yolo + t_ir50 + t_vitpose)

Prints one JSON object (indented, as the JAX tool prints it) with the card,
the batch, the ms per image of each component and the composite; ``--out``
also writes it to a file, which ``bench_cascade --baseline`` reads.

Departures from the JAX tool: it runs on the card (CUDA events around each
call, the median of ``--iters``), with TF32 off in cuBLAS and cuDNN so
that fp32 means fp32; the default batch is ``bench_cascade``'s 128 (the
JAX tool's 4 was for one CPU core); the JAX tool's second leg, its own
cascade on XLA's CPU backend, has no counterpart (``bench_cascade`` times
the port's). Without ``transformers`` the tool exits non-zero and names
it: nothing takes ViTPose-B's place.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from prpe_tpu_torch.tools.timing import card, log, time_ms


def _log(msg: str) -> None:
    log("bench_reference_torch", msg)


def vitpose_b():
    """ViTPose-B (usyd-community/vitpose-base-simple's geometry) with random
    weights: ViT-B/16 over 256x192, 17 keypoints, the simple decoder."""
    from transformers import VitPoseConfig, VitPoseForPoseEstimation
    from transformers.models.vitpose_backbone import VitPoseBackboneConfig

    bc = VitPoseBackboneConfig(num_hidden_layers=12, hidden_size=768, num_attention_heads=12,
                               intermediate_size=3072, image_size=[256, 192], num_channels=3)
    return VitPoseForPoseEstimation(VitPoseConfig(backbone_config=bc, num_labels=17))


def run(args) -> dict:
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.tools.reference_nets import TIRNet, TYolo

    try:
        import transformers  # noqa: F401
    except ImportError:
        raise SystemExit("bench_reference_torch: the 'transformers' package is not installed; "
                         "ViTPose-B is built from its VitPoseConfig and nothing replaces it")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(0)
    nets = {"yolo11n_640": (TYolo(nc=80), (3, 640, 640)),
            "ir50_112": (TIRNet(num_layers=50), (3, 112, 112)),
            "vitpose_b_256x192": (vitpose_b(), (3, 256, 192))}
    ms = {}
    with torch.inference_mode():
        for name, (net, shape) in nets.items():
            net = net.to(device).eval()
            x = torch.randn(args.batch, *shape, generator=gen, device=device)
            call = (lambda n=net, x=x: n(pixel_values=x)) if name.startswith("vitpose") \
                else (lambda n=net, x=x: n(x))
            ms[name] = time_ms(call, device, runs=args.iters, warmup=2)
            _log(f"{name}: {ms[name]:.3f} ms per batch of {args.batch}")
            del net, x
    composite = args.batch / ((2 * ms["yolo11n_640"] + ms["ir50_112"]
                               + ms["vitpose_b_256x192"]) / 1e3)
    return {"card": card(device), "device": str(device), "batch": args.batch,
            "tf32": False if device.type == "cuda" else None,
            "torch_eager_fp32_ms_per_image": {k: v / args.batch for k, v in ms.items()},
            "cascade_composite_img_per_sec": composite}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run(args)
    text = json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
