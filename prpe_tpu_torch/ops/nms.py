"""Fixed-shape batched non-maximum suppression (``prpe_tpu/ops/nms.py``).

Every shape is static: a top-K pre-selection of candidates, the greedy keep
mask (the CUDA kernel on the card, its plain version on the CPU), then the
kept detections compacted to the front and padded to ``max_det`` with a
validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from prpe_tpu_torch.ops.boxes import cxcywh_to_xyxy
from prpe_tpu_torch.ops.kernels.nms import greedy_scan, nms_keep


class Detections(NamedTuple):
    """Fixed-size batch of detections: boxes (..., max_det, 4) xyxy, scores
    (..., max_det), classes (..., max_det) int32 (-1 in padding), valid
    (..., max_det) bool."""

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ``lax.top_k``'s tie order: among equal
    values the lower index comes first. ``torch.topk`` promises no order, and
    the padding slots of the cascade are full of tied ``-inf`` entries."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def greedy_suppression_mask(iou: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Exact greedy keep mask of one image: ``iou`` (K, K) of score-sorted
    candidates, ``valid`` (K,) -> keep (K,) bool."""
    return greedy_scan((iou > iou_threshold)[None], valid.bool()[None])[0]


def _nms_batched(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, *,
                 conf_threshold: float, iou_threshold: float, max_det: int,
                 pre_nms_top_k: int, max_wh: float) -> Detections:
    """Batched fixed-shape NMS core over ``boxes`` (B, N, 4) xyxy and
    ``scores``/``classes`` (B, N)."""
    n = boxes.shape[-2]
    k = min(pre_nms_top_k, n)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    gated = torch.where(scores > conf_threshold, scores, neg_inf)
    top_scores, top_idx = topk_stable(gated, k)
    top_boxes = torch.gather(boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4))
    top_classes = torch.gather(classes, -1, top_idx)
    valid = top_scores > conf_threshold

    # class-offset trick in fp32: in bf16 the offsets would collapse boxes
    off_boxes = top_boxes.float() + top_classes.float()[..., None] * max_wh
    keep = nms_keep(off_boxes, valid, iou_threshold)

    kk = min(max_det, k)
    keep_scores = torch.where(keep, top_scores, neg_inf)
    det_scores, det_idx = topk_stable(keep_scores, kk)
    det_valid = torch.isfinite(det_scores)
    det_scores = torch.where(det_valid, det_scores, torch.zeros_like(det_scores))
    det_boxes = torch.gather(top_boxes, -2, det_idx[..., None].expand(*det_idx.shape, 4))
    det_classes = torch.gather(top_classes, -1, det_idx)
    det = Detections(
        boxes=torch.where(det_valid[..., None], det_boxes, torch.zeros_like(det_boxes)),
        scores=det_scores,
        classes=torch.where(det_valid, det_classes, torch.full_like(det_classes, -1)),
        valid=det_valid,
    )
    if kk < max_det:
        pad = max_det - kk
        pad_to = lambda x, value: torch.nn.functional.pad(  # noqa: E731
            x, (0, 0, 0, pad) if x.dim() == det.boxes.dim() else (0, pad), value=value)
        det = Detections(
            boxes=pad_to(det.boxes, 0.0),
            scores=pad_to(det.scores, 0.0),
            classes=pad_to(det.classes, -1),
            valid=pad_to(det.valid, False),
        )
    return det


def nms_single(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, *,
               conf_threshold: float = 0.001, iou_threshold: float = 0.65, max_det: int = 300,
               pre_nms_top_k: int = 1024, max_wh: float = 7680.0) -> Detections:
    """NMS of one image whose candidates already carry one class and score
    each: ``boxes`` (N, 4) xyxy, ``scores`` (N,), ``classes`` (N,) int ->
    :class:`Detections` of length ``max_det``."""
    det = _nms_batched(boxes[None], scores[None], classes[None],
                       conf_threshold=conf_threshold, iou_threshold=iou_threshold,
                       max_det=max_det, pre_nms_top_k=pre_nms_top_k, max_wh=max_wh)
    return Detections(*(x[0] for x in det))


def non_max_suppression(outputs: torch.Tensor, *, conf_threshold: float = 0.001,
                        iou_threshold: float = 0.65, max_det: int = 300,
                        pre_nms_top_k: int = 1024, max_wh: float = 7680.0) -> Detections:
    """Batched NMS over decoded YOLO outputs (B, A, 4 + nc): cxcywh pixel
    boxes followed by per-class scores. Each candidate keeps its best class."""
    nc = outputs.shape[-1] - 4
    boxes = cxcywh_to_xyxy(outputs[..., :4])
    cls_scores = outputs[..., 4:]
    if nc == 1:
        scores = cls_scores[..., 0]
        classes = torch.zeros(scores.shape, dtype=torch.int32, device=scores.device)
    else:
        scores, classes = cls_scores.max(dim=-1)
        classes = classes.to(torch.int32)
    return _nms_batched(boxes, scores, classes, conf_threshold=conf_threshold,
                        iou_threshold=iou_threshold, max_det=max_det,
                        pre_nms_top_k=pre_nms_top_k, max_wh=max_wh)
