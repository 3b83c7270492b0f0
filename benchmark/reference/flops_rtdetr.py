"""Operations and bytes of the RT-DETR cascade's work, counted on the
reference or from the shapes alone, so that they read the same whatever
implements it.

``cascade_rtdetr_flops`` counts one call's FLOPs with ``FlopCounterMode``
over the reference models on the meta device: RT-DETR and the face
detector on every frame, IR-50 on every face slot and ViTPose on every pose
slot (convolutions and matrix products; the deformable sampling, top-k,
crops, NMS and decoding are not counted). ``msda_least_s`` is the least
time of one launch of the deformable-attention kernel: the larger of its
bytes over HBM's bandwidth (the value tensor, the sampling locations and
the attention weights read once, the output written once, each element in
the configuration's dtype) and its operations over the dtype's peak (four
corner products and one weight product for each of B Lq H L P D elements).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import rtdetr as R
from benchmark.reference.cascade_rtdetr import meta_models
from benchmark.reference.flops import _BYTES, PEAKS, forward_flops


def rtdetr_flops(model: torch.nn.Module, size: int) -> int:
    """FLOPs of RT-DETR's eval forward over one ``size`` x ``size`` frame."""
    model.eval()
    with FlopCounterMode(display=False) as counter:
        R.detect(model, torch.empty(1, 3, size, size, device="meta"))
    return counter.get_total_flops()


def cascade_rtdetr_flops(cfg: dict, frames: int, face_slots: int, pose_slots: int) -> float:
    """FLOPs of one call of ``frames`` frames."""
    m = meta_models(cfg)
    s = cfg["yolo"]["image_size"]
    n = cfg["irnet"]["input_size"]
    person = rtdetr_flops(m["person_rtdetr"], s)
    face = forward_flops(m["face_yolo"], (1, 3, s, s))
    emb = forward_flops(m["irnet"], (1, 3, n, n))
    pose = forward_flops(m["vitpose"], (1, 3, *cfg["pose"]["input_size"]))
    return float((person + face) * frames + emb * face_slots + pose * pose_slots)


def msda_shapes(cfg: dict, frames: int) -> dict:
    """The kernel's shapes in a call of ``frames`` frames: B, Lq, S, H, D, L, P."""
    r = cfg["rtdetr"]
    size = cfg["yolo"]["image_size"]
    positions = sum((size // s) ** 2 for s in r["feat_strides"])
    return {"b": frames, "lq": r["num_queries"], "s": positions, "h": r["heads"],
            "d": r["hidden"] // r["heads"], "l": r["levels"], "p": r["points"]}


def msda_bytes(b: int, lq: int, s: int, h: int, d: int, l: int, p: int, itemsize: int) -> float:
    points = b * lq * h * l * p
    return float(itemsize * (b * s * h * d + 3 * points + b * lq * h * d))


def msda_ops(b: int, lq: int, s: int, h: int, d: int, l: int, p: int) -> float:
    return 5.0 * b * lq * h * l * p * d


def msda_least_s(shapes: dict, dtype: str) -> float:
    """The least time of one launch of the deformable-attention kernel."""
    moved = msda_bytes(**shapes, itemsize=_BYTES[dtype])
    return max(moved / PEAKS["hbm_bytes_per_s"], msda_ops(**shapes) / PEAKS["flops_per_s"][dtype])
