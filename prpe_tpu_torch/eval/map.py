"""Detection evaluation: PR curves, AP@[.5:.95], precision/recall/F1
(``prpe_tpu/eval/map.py``, an own numpy copy, op for op).

Host-side numpy re-derivations of:
  * per-image TP matrix over the 10 COCO IoU thresholds
    (reference: training/yolopt/util.py:99-120)
  * 101-point interpolated AP + F1-max operating point
    (reference: training/yolopt/util.py:225-300)
  * the simpler mAP50/75/50-95 aggregation used by the Lightning modules
    (reference: training/lightning/face_detection/module_v2.py:13-127)

These run on accumulated (device -> host) fixed-shape detection buffers after
the eval loop; the O(N log N) sort/interp work is tiny next to the model
forward. ``collect_per_image`` takes the eval step's ``Detections`` as numpy
arrays or CPU tensors; the trainer hands it host copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


@dataclasses.dataclass
class DetectionCurves:
    """Raw curve data behind the scalar metrics, for plotting
    (reference: training/yolopt/util.py:248,278-292 collects the same
    arrays when ``plot=True``).

    All curves are sampled on ``conf_grid`` (1000-point confidence axis)
    except ``pr_precision``, which is precision interpolated onto
    ``recall_grid`` at IoU 0.5 — the Precision-Recall plot's y values.
    """

    classes: np.ndarray          # (C,) class ids that had data
    conf_grid: np.ndarray        # (1000,)
    precision: np.ndarray        # (C, 1000)
    recall: np.ndarray           # (C, 1000)
    f1: np.ndarray               # (C, 1000)
    recall_grid: np.ndarray      # (1000,)
    pr_precision: np.ndarray     # (C, 1000) precision at IoU .5 vs recall
    ap: np.ndarray               # (C, T)


def smooth(y: np.ndarray, f: float = 0.1) -> np.ndarray:
    """Box filter over fraction ``f`` of the curve, edge-padded — applied to
    the mean-F1 curve before picking the operating point
    (reference: training/yolopt/util.py:172-177)."""
    nf = round(len(y) * f * 2) // 2 + 1  # odd filter width
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]))
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


def box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def match_detections(
    det_boxes: np.ndarray,
    det_classes: np.ndarray,
    gt_boxes: np.ndarray,
    gt_classes: np.ndarray,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """Unique matching -> TP matrix (n_det, n_thresh), reference-exact.

    Detections must be score-descending; classes must agree. Matching
    replicates the reference's unique-chain dedup (training/yolopt/
    util.py:108-120): candidate (gt, det) pairs sorted by IoU descending,
    then ``np.unique`` by det index (keeps each det's best gt, but REORDERS
    rows by det index), then ``np.unique`` by gt index over that reordered
    array — so when one gt could take several dets, the LOWEST-index
    (highest-score) det wins, not the highest-IoU one. A pure
    greedy-by-IoU matcher diverges from the reference's mAP numbers in
    multi-overlap scenes; parity is asserted against a line-level
    transcription in tests/test_map_golden.py.
    """
    n_det = len(det_boxes)
    correct = np.zeros((n_det, len(iou_thresholds)), bool)
    if n_det == 0 or len(gt_boxes) == 0:
        return correct
    iou = box_iou_matrix(gt_boxes, det_boxes)  # (n_gt, n_det)
    cls_ok = gt_classes[:, None] == det_classes[None, :]
    for t, thr in enumerate(iou_thresholds):
        gt_idx, det_idx = np.nonzero((iou >= thr) & cls_ok)
        if len(gt_idx) == 0:
            continue
        matches = np.stack(
            [gt_idx, det_idx, iou[gt_idx, det_idx]], 1)  # [gt, det, iou]
        if len(gt_idx) > 1:
            matches = matches[matches[:, 2].argsort()[::-1]]
            matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
            matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        correct[matches[:, 1].astype(int), t] = True
    return correct


def compute_ap(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
    eps: float = 1e-16,
    return_curves: bool = False,
):
    """PR-curve AP with 101-point COCO interpolation and an F1-max operating
    point (reference: training/yolopt/util.py:225-300 semantics).

    Args:
      tp: (N, T) TP matrix from :func:`match_detections` across all images.
      conf: (N,) scores; pred_cls: (N,) classes; target_cls: all gt classes.
      return_curves: also return a :class:`DetectionCurves` for plotting
        (the reference gathers the same arrays under ``plot=True``).

    Returns dict with precision, recall, f1, mAP50, mAP75, mAP50-95 —
    or ``(dict, DetectionCurves | None)`` when ``return_curves``.
    """
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]
    classes, counts = np.unique(target_cls, return_counts=True)

    if len(tp) == 0 or len(classes) == 0:
        zero = {"precision": 0.0, "recall": 0.0, "f1": 0.0,
                "mAP50": 0.0, "mAP75": 0.0, "mAP50-95": 0.0}
        return (zero, None) if return_curves else zero

    px = np.linspace(0, 1, 1000)
    n_t = tp.shape[1]
    ap = np.zeros((len(classes), n_t))
    p_curve = np.zeros((len(classes), 1000))
    r_curve = np.zeros((len(classes), 1000))
    pr_precision = np.zeros((len(classes), 1000))

    for ci, c in enumerate(classes):
        sel = pred_cls == c
        n_gt = counts[ci]
        if sel.sum() == 0 or n_gt == 0:
            continue
        fpc = (1 - tp[sel]).cumsum(0)
        tpc = tp[sel].cumsum(0)
        recall = tpc / (n_gt + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for t in range(n_t):
            m_rec = np.concatenate(([0.0], recall[:, t], [1.0]))
            m_pre = np.concatenate(([1.0], precision[:, t], [0.0]))
            m_pre = np.flip(np.maximum.accumulate(np.flip(m_pre)))
            x = np.linspace(0, 1, 101)
            ap[ci, t] = np.trapezoid(np.interp(x, m_rec, m_pre), x)
            if t == 0:
                # precision envelope vs recall at IoU .5 (util.py:281)
                pr_precision[ci] = np.interp(px, m_rec, m_pre)

    f1 = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i = smooth(f1.mean(0), 0.1).argmax()  # reference: util.py:297
    metrics = {
        "precision": float(p_curve[:, i].mean()),
        "recall": float(r_curve[:, i].mean()),
        "f1": float(f1[:, i].mean()),
        "mAP50": float(ap[:, 0].mean()),
        "mAP75": float(ap[:, min(5, n_t - 1)].mean()),
        "mAP50-95": float(ap.mean()),
    }
    if return_curves:
        curves = DetectionCurves(
            classes=classes, conf_grid=px, precision=p_curve, recall=r_curve,
            f1=f1, recall_grid=px, pr_precision=pr_precision, ap=ap,
        )
        return metrics, curves
    return metrics


def evaluate_detections(
    per_image: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    return_curves: bool = False,
):
    """End-to-end detection metrics from per-image
    (det_boxes, det_scores, det_classes, gt_boxes, gt_classes) tuples
    (detections score-sorted, already NMS'd and validity-filtered).

    With ``return_curves`` also returns the :class:`DetectionCurves`
    (or None when there is no data) for plotting."""
    all_tp, all_conf, all_cls, all_gt_cls = [], [], [], []
    for det_boxes, det_scores, det_classes, gt_boxes, gt_classes in per_image:
        tp = match_detections(det_boxes, det_classes, gt_boxes, gt_classes)
        all_tp.append(tp)
        all_conf.append(det_scores)
        all_cls.append(det_classes)
        all_gt_cls.append(gt_classes)
    if not all_tp:
        zero = {"precision": 0.0, "recall": 0.0, "f1": 0.0,
                "mAP50": 0.0, "mAP75": 0.0, "mAP50-95": 0.0}
        return (zero, None) if return_curves else zero
    return compute_ap(
        np.concatenate(all_tp),
        np.concatenate(all_conf),
        np.concatenate(all_cls),
        np.concatenate(all_gt_cls) if all_gt_cls else np.zeros(0),
        return_curves=return_curves,
    )


def collect_per_image(outputs, model_image_size: int) -> List[Tuple]:
    """Flatten accumulated (Detections, batch) pairs into the per-image
    (det_boxes, det_scores, det_classes, gt_boxes_xyxy, gt_classes) tuples
    consumed by :func:`evaluate_detections`."""
    per_image = []
    for det, batch in outputs:
        boxes = np.asarray(det.boxes)
        scores = np.asarray(det.scores)
        classes = np.asarray(det.classes)
        valid = np.asarray(det.valid)
        gt_boxes_n = np.asarray(batch["gt_boxes"])  # cxcywh normalized
        gt_mask = np.asarray(batch["gt_mask"])
        gt_labels = np.asarray(batch["gt_labels"])
        for b in range(boxes.shape[0]):
            v = valid[b]
            g = gt_mask[b]
            gb = gt_boxes_n[b][g] * model_image_size
            gt_xyxy = np.concatenate(
                [gb[:, :2] - gb[:, 2:] / 2, gb[:, :2] + gb[:, 2:] / 2], -1
            )
            per_image.append(
                (boxes[b][v], scores[b][v], classes[b][v], gt_xyxy, gt_labels[b][g])
            )
    return per_image


def detection_eval_hook(model_image_size: int):
    """Builds the round-robin ``eval_hook`` that turns accumulated
    (Detections, batch) pairs into mAP metrics."""

    def hook(outputs) -> Dict[str, float]:
        return evaluate_detections(collect_per_image(outputs, model_image_size))

    return hook
