"""Box geometry (``prpe_tpu/ops/boxes.py``): cxcywh -> xyxy and plain IoU.

Boxes are ``(..., 4)`` float tensors; every function broadcasts over the
leading dims.
"""

from __future__ import annotations

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


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, kind: str = "iou",
                 eps: float = 1e-7) -> torch.Tensor:
    """IoU matrix between ``(..., N, 4)`` and ``(..., M, 4)`` -> ``(..., N, M)``.

    Only ``kind="iou"`` is on the serving path; the GIoU/DIoU/CIoU variants
    of the JAX package come with the losses.
    """
    if kind != "iou":
        raise ValueError(f"unsupported iou kind: {kind}")
    return iou(boxes1[..., :, None, :], boxes2[..., None, :, :], eps)
