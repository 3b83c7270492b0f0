"""Operations and bytes of the work, counted on the reference, so that they
read the same whatever implements it; and the card's published peaks.

``cascade_flops`` counts one call's FLOPs with ``FlopCounterMode`` over the
reference models on the meta device (shapes only): both detectors on every
frame, IR-50 on every face slot and ViTPose on every pose slot, as the
runner computes them whether a slot is valid or not. Crops, NMS and decoding
are not counted. ``mhsa_least_s`` is the least time of one launch of the
packed attention kernel (K2): its 4 B H T^2 D FLOPs over the peak, or q, k,
v and the output moved once over HBM's bandwidth, whichever is larger.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.cascade import meta_models

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "peaks.json").read_text())
_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def forward_flops(model: torch.nn.Module, shape) -> int:
    """FLOPs of one eval-mode forward of ``model`` over an input of ``shape``."""
    model.eval()
    with FlopCounterMode(display=False) as counter:
        model(torch.empty(shape, device="meta"))
    return counter.get_total_flops()


def cascade_flops(cfg: dict, frames: int, face_slots: int, pose_slots: int) -> float:
    """FLOPs of one call of ``frames`` frames."""
    m = meta_models(cfg)
    s = cfg["yolo"]["image_size"]
    n = cfg["irnet"]["input_size"]
    yolo = forward_flops(m["person_yolo"], (1, 3, s, s))
    face = forward_flops(m["irnet"], (1, 3, n, n))
    pose = forward_flops(m["vitpose"], (1, 3, *cfg["pose"]["input_size"]))
    return float(2 * yolo * frames + face * face_slots + pose * pose_slots)


def vit_tokens(pose_cfg: dict) -> int:
    """Tokens of the ViT: the patch grid of the crop, padding 2."""
    p = pose_cfg["patch_size"]
    h, w = pose_cfg["input_size"]
    return ((h + 4 - p) // p + 1) * ((w + 4 - p) // p + 1)


def mhsa_least_s(batch: int, tokens: int, heads: int, head_dim: int, dtype: str) -> float:
    """The least time of one K2 launch on the card."""
    flops = 4.0 * batch * heads * tokens * tokens * head_dim
    moved = 4.0 * batch * tokens * heads * head_dim * _BYTES[dtype]
    return max(flops / PEAKS["flops_per_s"][dtype], moved / PEAKS["hbm_bytes_per_s"])

