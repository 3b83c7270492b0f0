"""Cascade inference CLI: enroll identities, then run selective pose on images.

    python -m prpe_tpu_torch.cli.infer IMAGE ... [--enroll FACE ...]
        [--checkpoint STATE_DICT.pt] [--preset full|tiny] [--device cpu]

Detects every person, matches faces against the enrolled gallery and writes
keypoints only for the people whose face matched, as JSON (the JAX
package's ``cli/infer.py`` flags and output keys). Runs on CUDA unless
``--device`` names another device. ``--checkpoint`` is a port state-dict
file (``torch.save`` of ``CascadeModel.state_dict()``): from
``cli/export.py::save_inference_checkpoint``, or from a JAX variable tree
through ``models/porting.py::from_jax_variables``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
from prpe_tpu_torch.core.device import resolve_device
from prpe_tpu_torch.data.image import load_image, resize_image
from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner


def build_model(preset: str = "full", device=None) -> CascadeModel:
    """The cascade's models at ``preset``, fp32 with seeded weights:
    ``full`` (YOLOv11-n, IR-50, ViTPose-B) or ``tiny`` (IR-18 and a 1-layer
    ViT of width 32 at 64x48, for quick CPU runs)."""
    if preset == "tiny":
        return CascadeModel(
            detection=DetectionConfig(pre_nms_top_k=64),
            pose_cfg=PoseConfig(input_size=(64, 48), heatmap_size=(16, 12),
                                vit_hidden=32, vit_layers=1, vit_heads=2),
            irnet_layers=18, device=device)
    return CascadeModel(detection=DetectionConfig(), pose_cfg=PoseConfig(), device=device)


def _unit(images_uint8: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> fp32 in [0, 1] on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(images_uint8)).to(dev).float() / 255.0


@torch.inference_mode()
def embed_gallery(model: CascadeModel, enroll_uint8: Optional[np.ndarray]) -> torch.Tensor:
    """Enrolled face images (N, 112, 112, 3) uint8, each taken whole as the
    face crop -> (N, 512) embeddings: (x - 0.5) / 0.5, RGB -> BGR, IR-Net.
    No image gives one all-zero identity, which matches no face."""
    if enroll_uint8 is None or len(enroll_uint8) == 0:
        return torch.zeros(1, 512, device=model.device)
    crops = (_unit(enroll_uint8, model.device) - 0.5) / 0.5
    emb, _ = model.irnet(crops.flip(-1))
    return emb.float()


def run(model: CascadeModel, images_uint8: np.ndarray, enroll_uint8: Optional[np.ndarray],
        threshold: float = 0.4, names: Optional[Sequence[str]] = None) -> List[dict]:
    """The CLI's path on arrays: ``images_uint8`` (B, S, S, 3) uint8 frames,
    ``enroll_uint8`` (N, 112, 112, 3) uint8 faces or None -> one dict per
    frame with its ``image`` name (``names``, default the index) and the
    ``persons``, ``faces`` and ``poses`` found, as the JSON output."""
    runner = build_cascade_runner(model, CascadeConfig(match_threshold=threshold),
                                  device=model.device)
    gallery = embed_gallery(model, enroll_uint8)
    res = runner(_unit(images_uint8, model.device), gallery)
    res = type(res)(*(type(x)(*(t.cpu() for t in x)) if isinstance(x, tuple) else x.cpu()
                      for x in res))
    names = [str(i) for i in range(len(images_uint8))] if names is None else names
    results = []
    for b, name in enumerate(names):
        persons = [
            {"box": res.persons.boxes[b, i].tolist(),
             "score": float(res.persons.scores[b, i]),
             "gated": bool(res.person_gated[b, i])}
            for i in range(res.persons.boxes.shape[1]) if res.persons.valid[b, i]
        ]
        faces = [
            {"box": res.faces.boxes[b, i].tolist(),
             "score": float(res.faces.scores[b, i]),
             "identity": int(res.face_identity[b, i]),
             "similarity": float(res.face_similarity[b, i])}
            for i in range(res.faces.boxes.shape[1]) if res.faces.valid[b, i]
        ]
        poses = [
            {"box": res.pose_boxes[g].tolist(),
             "keypoints": res.pose_keypoints[g].tolist(),
             "scores": res.pose_scores[g].tolist()}
            for g in range(len(res.pose_valid))
            if res.pose_valid[g] and res.pose_image_idx[g] == b
        ]
        results.append({"image": str(name), "persons": persons, "faces": faces, "poses": poses})
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("images", nargs="+", help="input image paths")
    ap.add_argument("--enroll", nargs="*", default=[],
                    help="face images of target identities (gallery)")
    ap.add_argument("--checkpoint", default=None,
                    help="port state-dict file of the cascade's models (optional)")
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--match-threshold", type=float, default=0.4)
    ap.add_argument("--output", default=None, help="write JSON results here")
    ap.add_argument("--preset", choices=("full", "tiny"), default="full",
                    help="'tiny' shrinks every component (IR-18, 1-layer ViT) for quick "
                         "CPU runs")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    model = build_model(args.preset, resolve_device(args.device))
    if args.checkpoint:  # bf16 entries are widened into the fp32 parameters
        model.load_state_dict(torch.load(args.checkpoint, map_location="cpu",
                                         weights_only=True), strict=True)

    def load_batch(paths, size):
        return np.stack([resize_image(load_image(p), (size, size)) for p in paths])

    enroll = load_batch(args.enroll, 112) if args.enroll else None
    results = run(model, load_batch(args.images, args.image_size), enroll,
                  args.match_threshold, names=args.images)
    text = json.dumps(results, indent=2)
    if args.output:
        pathlib.Path(args.output).write_text(text)
        print(f"wrote {args.output}")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
