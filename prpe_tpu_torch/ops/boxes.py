"""Box geometry (``prpe_tpu/ops/boxes.py``): format conversion and the IoU
family (plain IoU, CIoU with the reference's semantics, and the GIoU / DIoU
/ CIoU matrices of ``pairwise_iou``).

Boxes are ``(..., 4)`` float tensors; every function broadcasts over the
leading dims.
"""

from __future__ import annotations

import math

import torch


def cxcywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = box.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes -> (...,)."""
    w = (box[..., 2] - box[..., 0]).clamp(min=0.0)
    h = (box[..., 3] - box[..., 1]).clamp(min=0.0)
    return w * h


def iou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU of xyxy boxes (broadcasting) -> (...,).

    The expression order (``area1 + area2 - inter + eps``, then one division)
    is the one the NMS kernel repeats bit for bit.
    """
    lt = torch.maximum(box1[..., :2], box2[..., :2])
    rb = torch.minimum(box1[..., 2:], box2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(box1) + box_area(box2) - inter + eps
    return inter / union


def ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU of xyxy boxes (broadcasting) -> (...,), as the JAX
    package computes it: ``eps`` added to the heights only, the intersection
    clamped at 0, no gradient through the aspect-ratio weight ``alpha``."""
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0.0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0.0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou_ = inter / union
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4.0
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    with torch.no_grad():
        alpha = v / (v - iou_ + (1.0 + eps))
    return iou_ - (rho2 / c2 + v * alpha)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, kind: str = "iou",
                 eps: float = 1e-7) -> torch.Tensor:
    """IoU matrix between ``(..., N, 4)`` and ``(..., M, 4)`` -> ``(..., N, M)``,
    ``kind`` in {iou, giou, diou, ciou}."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    if kind == "iou":
        return iou(b1, b2, eps)
    if kind == "ciou":
        return ciou(b1, b2, eps)
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(b1) + box_area(b2) - inter + eps
    iou_ = inter / union
    cwh = (torch.maximum(b1[..., 2:], b2[..., 2:]) - torch.minimum(b1[..., :2], b2[..., :2])
           ).clamp(min=0.0)
    if kind == "giou":
        c_area = cwh[..., 0] * cwh[..., 1] + eps
        return iou_ - (c_area - union) / c_area
    if kind == "diou":
        c2 = cwh[..., 0] ** 2 + cwh[..., 1] ** 2 + eps
        rho2 = (((b2[..., :2] + b2[..., 2:]) / 2 - (b1[..., :2] + b1[..., 2:]) / 2) ** 2).sum(-1)
        return iou_ - rho2 / c2
    raise ValueError(f"unknown iou kind: {kind}")
