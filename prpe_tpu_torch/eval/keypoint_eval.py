"""COCO-style keypoint evaluation (OKS AP suite), dependency-free
(``prpe_tpu/eval/keypoint_eval.py``, an own numpy copy).

The reference shells out to pycocotools' COCOeval
(reference: training/lightning/pose_estimation/module.py:578-628); that
package is not in this image, so the keypoint branch of the published COCO
evaluation protocol is implemented here directly, matching COCOeval's
semantics exactly (validated against a line-level transcription of the
public cocoeval.py in tests/test_keypoint_eval.py, which
tests/test_torch_eval.py runs through this copy too):

  * OKS between a predicted 17-keypoint skeleton and a gt annotation:
      OKS = mean_i exp(-d_i^2 / (2 s^2 k_i^2))  over labeled keypoints,
    with s^2 = gt area and k_i = 2*sigma_i (COCO constants); gts with zero
    labeled keypoints score via the bbox-proximity fallback
  * gts are IGNORED (not dropped) when iscrowd or num_keypoints == 0, or
    outside the area range: detections matching them become ignored, not
    false positives; crowd gts can absorb multiple detections
  * per-image greedy matching of score-sorted predictions (maxDets = 20) to
    ignore-sorted gts at OKS thresholds .50:.05:.95; unmatched detections
    whose own area falls outside the range are ignored
  * AP/AR with 101-point interpolation, plus medium (32^2..96^2) and large
    (>96^2) area ranges — the stats the reference logs at module.py:612-624.
    Ranges with no evaluable gt yield -1, exactly as COCOeval prints.

Prediction/annotation dicts use the COCO json schema so results remain
interchangeable with pycocotools when it is available. Prediction ``area``/
``bbox``, when absent, are derived from the keypoint extent the way
COCO.loadRes does for keypoint results.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

KPT_SIGMAS = np.array(
    [.026, .025, .025, .035, .035, .079, .079, .072, .072, .062, .062,
     .107, .107, .087, .087, .089, .089], np.float32)

OKS_THRESHOLDS = np.linspace(0.5, 0.95, 10)
# COCOeval's exact (inclusive) bounds — note area 96^2 belongs to BOTH
# medium and large, and "all" is capped at 1e5^2, not inf
AREA_RANGES = {
    "all": (0.0**2, 1e5**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
}
MAX_DETS = 20  # COCOeval keypoints default (Params.setKpParams)


def compute_oks(pred_kpts: np.ndarray, gt_kpts: np.ndarray, gt_area: float,
                gt_bbox=None) -> float:
    """OKS of one (17, 3) prediction vs one (17, 3) gt annotation.

    With zero labeled gt keypoints, falls back to COCOeval's bbox-proximity
    distance (cocoeval.py computeOks) when ``gt_bbox`` (xywh) is given,
    else 0.
    """
    vis = gt_kpts[:, 2] > 0
    var = (2.0 * KPT_SIGMAS) ** 2
    if vis.any():
        d2 = (pred_kpts[:, 0] - gt_kpts[:, 0]) ** 2 \
            + (pred_kpts[:, 1] - gt_kpts[:, 1]) ** 2
        e = d2 / var / (gt_area + np.spacing(1)) / 2.0
        return float(np.exp(-e[vis]).mean())
    if gt_bbox is None:
        return 0.0
    bx, by, bw, bh = gt_bbox
    x0, x1 = bx - bw, bx + 2 * bw
    y0, y1 = by - bh, by + 2 * bh
    dx = np.maximum(0, x0 - pred_kpts[:, 0]) + np.maximum(0, pred_kpts[:, 0] - x1)
    dy = np.maximum(0, y0 - pred_kpts[:, 1]) + np.maximum(0, pred_kpts[:, 1] - y1)
    e = (dx**2 + dy**2) / var / (gt_area + np.spacing(1)) / 2.0
    return float(np.exp(-e).mean())


def _interp_ap(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """101-point interpolated AP (the COCO accumulate step)."""
    # recalls from a TP cumsum are already non-decreasing
    precisions = np.maximum.accumulate(precisions[::-1])[::-1]
    x = np.linspace(0, 1, 101)
    interp = np.zeros_like(x)
    idx = np.searchsorted(recalls, x, side="left")
    ok = idx < len(precisions)
    interp[ok] = precisions[idx[ok]]
    return float(interp.mean())


def _pred_geometry(p: dict) -> Tuple[float, np.ndarray]:
    """(area, kpts) for a result dict. COCO.loadRes UNCONDITIONALLY
    overwrites keypoint-result area with the keypoint-extent rectangle
    (pycocotools coco.py loadRes: ann['area'] = (x1-x0)*(y1-y0)), even when
    the result carries its own 'area' (the reference's prediction dicts do —
    pose_estimation/module.py:552-559); honoring a caller area here would
    shift the medium/large bucketing and diverge from COCOeval."""
    k = np.asarray(p["keypoints"], np.float32).reshape(-1, 3)
    x, y = k[:, 0], k[:, 1]
    return float((x.max() - x.min()) * (y.max() - y.min())), k


def evaluate_keypoints(
    predictions: Sequence[dict],
    annotations: Sequence[dict],
    thresholds: np.ndarray = OKS_THRESHOLDS,
    max_dets: int = MAX_DETS,
) -> Dict[str, float]:
    """COCO keypoint AP suite with COCOeval-exact matching semantics.

    Args:
      predictions: COCO result dicts
        {image_id, keypoints [51], score, (bbox), (area)}.
      annotations: COCO gt dicts
        {image_id, keypoints [51], area, (bbox), (iscrowd), (num_keypoints)}.

    Returns {AP, AP50, AP75, APm, APl, AR, AR50, AR75, ARm, ARl}; a stat is
    -1.0 when its area range contains no evaluable gt (COCOeval convention).
    """
    T = len(thresholds)
    gts_by_img: Dict[int, List[dict]] = defaultdict(list)
    for a in annotations:
        kpts = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
        nk = a.get("num_keypoints", int((kpts[:, 2] > 0).sum()))
        gts_by_img[a["image_id"]].append({
            "kpts": kpts,
            "area": float(a.get("area", 0.0)),
            "bbox": a.get("bbox"),
            "iscrowd": int(a.get("iscrowd", 0)),
            # cocoeval.py _prepare: keypoint gts ignore when crowd or unlabeled
            "ignore": int(bool(a.get("iscrowd", 0)) or nk == 0),
        })
    preds_by_img: Dict[int, List[dict]] = defaultdict(list)
    for p in predictions:
        area, kpts = _pred_geometry(p)
        preds_by_img[p["image_id"]].append(
            {"kpts": kpts, "score": float(p["score"]), "area": area})

    # per-image: score-sort + truncate dets, compute the OKS matrix once
    images = []
    for img_id in set(gts_by_img) | set(preds_by_img):
        gts = gts_by_img.get(img_id, [])
        dts = sorted(preds_by_img.get(img_id, []), key=lambda d: -d["score"])
        dts = dts[:max_dets]
        oks = np.zeros((len(dts), len(gts)))
        for j, g in enumerate(gts):
            for i, d in enumerate(dts):
                oks[i, j] = compute_oks(d["kpts"], g["kpts"], g["area"],
                                        g["bbox"])
        images.append((gts, dts, oks))

    out: Dict[str, float] = {}
    for area_name, (lo, hi) in AREA_RANGES.items():
        scores_all: List[float] = []
        dtm_all: List[np.ndarray] = []  # (T,) matched flag per det
        dtig_all: List[np.ndarray] = []  # (T,) ignore flag per det
        n_gt = 0
        for gts, dts, oks in images:
            gt_ig = np.array(
                [g["ignore"] or not (lo <= g["area"] <= hi) for g in gts],
                bool)
            n_gt += int((~gt_ig).sum())
            if not dts:
                continue
            # non-ignored gts first (stable), as evaluateImg sorts them
            order = np.argsort(gt_ig, kind="stable")
            gt_ig = gt_ig[order]
            crowd = np.array([gts[j]["iscrowd"] for j in order], int) \
                if len(gts) else np.zeros(0, int)
            m_oks = oks[:, order]

            dtm = np.zeros((len(dts), T), bool)
            dtig = np.zeros((len(dts), T), bool)
            for t, thr in enumerate(thresholds):
                gt_used = np.zeros(len(gts), bool)
                for i in range(len(dts)):  # score order
                    best, v = -1, min(thr, 1 - 1e-10)
                    for j in range(len(gts)):
                        if gt_used[j] and not crowd[j]:
                            continue
                        # once matched to a real gt, stop at the ignored tail
                        if best > -1 and not gt_ig[best] and gt_ig[j]:
                            break
                        if m_oks[i, j] < v:
                            continue
                        best, v = j, m_oks[i, j]
                    if best >= 0:
                        gt_used[best] = True
                        dtm[i, t] = True
                        dtig[i, t] = gt_ig[best]
            # unmatched detections outside the area range are ignored
            d_out = np.array([not (lo <= d["area"] <= hi) for d in dts], bool)
            dtig |= (~dtm) & d_out[:, None]
            scores_all.extend(d["score"] for d in dts)
            dtm_all.extend(dtm)
            dtig_all.extend(dtig)

        suffix = {"all": "", "medium": "m", "large": "l"}[area_name]
        if n_gt == 0:
            out[f"AP{suffix}"] = out[f"AR{suffix}"] = -1.0
            if area_name == "all":
                out.update({"AP50": -1.0, "AP75": -1.0,
                            "AR50": -1.0, "AR75": -1.0})
            continue

        if scores_all:
            order = np.argsort(-np.asarray(scores_all), kind="stable")
            tp = np.stack(dtm_all)[order]  # (N, T)
            ig = np.stack(dtig_all)[order]
        else:
            tp = ig = np.zeros((0, T), bool)

        aps, ars = [], []
        for t in range(T):
            keep = ~ig[:, t]
            tpc = (tp[keep, t]).cumsum()
            fpc = (~tp[keep, t]).cumsum()
            recall = tpc / n_gt
            precision = tpc / np.maximum(tpc + fpc, np.spacing(1))
            aps.append(_interp_ap(recall, precision) if len(tpc) else 0.0)
            ars.append(float(recall[-1]) if len(tpc) else 0.0)

        out[f"AP{suffix}"] = float(np.mean(aps))
        out[f"AR{suffix}"] = float(np.mean(ars))
        if area_name == "all":
            # locate .5/.75 in the (possibly caller-supplied) threshold grid
            # instead of assuming the default 10-point layout
            i50 = int(np.argmin(np.abs(thresholds - 0.50)))
            i75 = int(np.argmin(np.abs(thresholds - 0.75)))
            out["AP50"] = aps[i50]
            out["AP75"] = aps[i75]
            out["AR50"] = ars[i50]
            out["AR75"] = ars[i75]
    return out
