"""The comparison that decides ``correct`` for the cascade cells.

The program's answers are discrete past each stage (which candidates NMS
kept, which faces took the F embedding slots, which persons the gate let
through), and at bfloat16 near-ties go either way. So the reference follows
the program's own decisions stage by stage and judges each by what it says,
the way a served token is judged by how far its logit lies below the
reference's best. Each judged item gives an error; a number is the
``QUANTILE`` of its items over every judged call (the largest errors of a
randomly weighted network have a long tail that bfloat16 and the float8
control share, while the bulk moves with the precision):

- ``det_err`` (per served detection): the distance, score and box
  (coordinates over the image size), to the nearest reference candidate.
- ``nms_gap`` (per frame and detector): greedy NMS replayed on the
  reference's scores with the program's picks: at each rank, how far the
  best reference candidate still free lies above the program's pick (or
  above the confidence gate where the program served nothing), and how far
  two of its boxes overlap beyond the IoU threshold; the largest over the
  ranks. ``NMS_IOU_BAND`` around the threshold is left undecided, since
  bfloat16 boxes move an IoU by that much.
- ``face_gap`` (per face slot): the program's face crop embedded by the
  reference: the gap between the program's similarity and the reference's
  best, and between the reference's best and its similarity to the
  identity the program chose.
- ``pose_gap`` (per keypoint of a valid pose slot): the program's crop run
  through the reference ViTPose: how far below the heatmap's maximum the
  program's keypoint cell lies, and the neighbour difference where its
  quarter-cell shift points the other way, in units of the heatmap's
  standard deviation.
- ``pose_score_err`` (per keypoint): the relative error of its score.
- ``structure``: the count, over every judged call, of answers that the
  program's own earlier answers fix exactly (face slots, matches, the gate,
  the pose slots and their boxes, computed in the dtype the program holds
  them in) and that disagree with them. Its limit is 0.

Those follow the program's decisions, so a fault that moves an upstream
stage moves what the later stages are held to. Two numbers do not: the
reference runs its own whole cascade on the same frames and gallery
(:meth:`ReferenceCascade.run`), and its final answers are paired one to one
with the program's, in the same frame (a pose slot: the same image), at
IoU ``MATCH_IOU`` or more, best first:

- ``e2e_miss`` (per final answer of either side: the valid person and face
  detections, the gated persons, the valid pose slots): the share that
  finds no partner on the other side.
- ``e2e_box_err`` (per paired detection): the largest coordinate
  difference over the image size.

The keypoints of paired pose slots are not compared: a random ViTPose's
heatmap maximum moves with a shift of its crop by a few pixels, so they
differ as much under bfloat16 as under the float8 control; ``pose_gap``
judges them on the program's own crop.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import cascade as rc

NMS_IOU_BAND = 0.15
MATCH_IOU = 0.5
QUANTILE = 0.75
NUMBERS = ("det_err", "nms_gap", "face_gap", "pose_gap", "pose_score_err", "structure",
           "e2e_miss", "e2e_box_err")
SHARES = ("e2e_miss",)  # read as the mean of 0/1 items, not a quantile


def _det_items(boxes_ref, scores_ref, out_boxes, out_scores, out_valid, c, size: float):
    """Per served detection its error, per frame its NMS gap, for one
    detector over a batch."""
    b, k = out_valid.shape
    ob, os_ = out_boxes.float(), out_scores.float()
    m = torch.empty(b, k, dtype=torch.long, device=ob.device)
    for i in range(0, b, 8):  # (8, K, A, 4) at a time
        d = ((os_[i:i + 8, :, None] - scores_ref[i:i + 8, None, :]).abs()
             + (ob[i:i + 8, :, None, :] - boxes_ref[i:i + 8, None, :, :]).abs().amax(-1) / size)
        m[i:i + 8] = d.argmin(-1)
    pick_s = torch.gather(scores_ref, 1, m)
    pick_b = torch.gather(boxes_ref, 1, m[..., None].expand(-1, -1, 4))
    del m
    err = torch.maximum((os_ - pick_s).abs(), (ob - pick_b).abs().amax(-1) / size)
    det_err = err[out_valid]

    thr, iou_thr = c["conf_threshold"], c["iou_threshold"]
    gated = torch.where(scores_ref > thr, scores_ref, float("-inf"))
    pool_s, idx = rc.top_by_score(gated, min(c["pre_nms_top_k"], gated.shape[1]))
    pool_b = torch.gather(boxes_ref, 1, idx[..., None].expand(-1, -1, 4))
    free = torch.isfinite(pool_s)
    gap = torch.zeros(b, device=ob.device)
    for r in range(k):
        has = free.any(1)
        best = torch.where(free, pool_s, float("-inf")).amax(1)
        v = out_valid[:, r]
        gap = torch.maximum(gap, torch.where(v, (torch.where(has, best, thr) - pick_s[:, r])
                                             .clamp(min=0), 0.0))
        gap = torch.maximum(gap, torch.where(~v & has, best - thr, 0.0))
        if r:
            over = rc.iou(ob[:, r:r + 1], ob[:, :r]) - (iou_thr + NMS_IOU_BAND)
            over = torch.where(v[:, None] & out_valid[:, :r], over.clamp(min=0), 0.0)
            gap = torch.maximum(gap, over.amax(1))
        free &= ~(v[:, None] & (rc.iou(ob[:, r:r + 1], pool_b) > iou_thr - NMS_IOU_BAND))
    return det_err, gap


def _structure(out, c, face_capacity: int, pose_capacity: int) -> int:
    """Answers fixed exactly by the program's earlier answers that disagree."""
    kp = c["max_persons"]
    bad = 0
    f_idx, f_valid = rc.face_slots(out["face_scores"], out["face_valid"], face_capacity)
    in_slot = torch.zeros(out["face_valid"].numel(), dtype=torch.bool, device=f_idx.device)
    in_slot[f_idx[f_valid]] = True
    in_slot = in_slot.view_as(out["face_valid"])
    bad += int(((out["face_similarity"] != -1.0) & ~in_slot).sum())
    matched = (out["face_similarity"] > c["match_threshold"]) & out["face_valid"]
    bad += int(((out["face_identity"] >= 0) != matched).sum())
    gated = rc.gate(out["person_boxes"], out["person_valid"], out["face_boxes"],
                    out["face_valid"], out["face_identity"] >= 0)
    bad += int((gated != out["person_gated"]).sum())
    p_idx, p_valid = rc.pose_slots(out["person_scores"], out["person_gated"], pose_capacity)
    bad += int((p_valid != out["pose_valid"]).sum())
    want_img = torch.where(p_valid, p_idx // kp, -1)
    bad += int((want_img != out["pose_image_idx"]).sum())
    want_box = out["person_boxes"].reshape(-1, 4)[p_idx]
    bad += int(((want_box != out["pose_boxes"]).any(-1) & p_valid).sum())
    return bad


def _face_items(models, frames, gallery, out, c, face_capacity: int, block: int):
    kf = c["max_faces"]
    f_idx, f_valid = rc.face_slots(out["face_scores"], out["face_valid"], face_capacity)
    f_idx = f_idx[f_valid]
    if f_idx.numel() == 0:
        return frames.new_zeros(0)
    emb = rc.embed(models["irnet"], frames, out["face_boxes"].float().reshape(-1, 4)[f_idx],
                   f_idx // kf, block)
    sims = emb @ gallery.T
    best = sims.amax(-1)
    gap = (out["face_similarity"].reshape(-1)[f_idx] - best).abs()
    ident = out["face_identity"].reshape(-1)[f_idx]
    chosen = sims.gather(1, ident.clamp(min=0)[:, None])[:, 0]
    return torch.maximum(gap, torch.where(ident >= 0, best - chosen, 0.0))


def _pose_items(models, frames, out, pose_cfg, block: int):
    valid = out["pose_valid"]
    if not bool(valid.any()):
        return frames.new_zeros(0), frames.new_zeros(0)
    own = out["pose_boxes"][valid]
    boxes = own.float()
    hm = rc.heatmaps(models["vitpose"], frames, boxes, out["pose_image_idx"][valid],
                     pose_cfg["input_size"], block)
    g, k, h, w = hm.shape
    kp = out["pose_keypoints"].float()[valid]
    # the box's width and height as the program took them, in its boxes' dtype
    bw = (own[:, 2] - own[:, 0]).float().clamp(min=1e-3)[:, None]
    bh = (own[:, 3] - own[:, 1]).float().clamp(min=1e-3)[:, None]
    u = (kp[..., 0] - boxes[:, 0:1]) / bw * w - 0.5
    v = (kp[..., 1] - boxes[:, 1:2]) / bh * h - 0.5
    ix, iy = u.round().long().clamp(0, w - 1), v.round().long().clamp(0, h - 1)
    gi = torch.arange(g, device=hm.device)[:, None]
    ki = torch.arange(k, device=hm.device)[None, :]
    at = lambda yy, xx: hm[gi, ki, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]  # noqa: E731
    flat = hm.reshape(g, k, -1)
    scale = flat.std(-1).clamp(min=1e-6)
    gap = (flat.amax(-1) - at(iy, ix)) / scale
    for shift, dx, dy in ((u - u.round(), 1, 0), (v - v.round(), 0, 1)):
        diff = at(iy + dy, ix + dx) - at(iy - dy, ix - dx)
        said = torch.where(shift.abs() < 0.125, 0.0, torch.sign(shift))
        gap = torch.maximum(gap, torch.where(said != torch.sign(diff), diff.abs() / scale, 0.0))
    want = rc.keypoint_scores(hm, boxes)
    score_err = (out["pose_scores"].float()[valid] - want).abs() / want.clamp(min=1e-12)
    return gap.flatten(), score_err.flatten()


def _pairs(iou: torch.Tensor) -> torch.Tensor:
    """One-to-one pairs of the rows and columns of each matrix of ``iou``
    (..., R, C; -1 where a pair is not allowed), best first, at ``MATCH_IOU``
    or more -> a bool mask of the pairs."""
    iou = iou.clone()
    pairs = torch.zeros_like(iou, dtype=torch.bool)
    for _ in range(min(iou.shape[-2:])):
        best, at = iou.flatten(-2).max(-1)
        ok = best >= MATCH_IOU
        if not bool(ok.any()):
            break
        pick = torch.zeros_like(iou.flatten(-2), dtype=torch.bool)
        pick.scatter_(-1, at[..., None], ok[..., None])
        pick = pick.view_as(iou)
        pairs |= pick
        iou.masked_fill_(pick.any(-1, keepdim=True) | pick.any(-2, keepdim=True), -1.0)
    return pairs


def _paired(ref_boxes, ref_valid, out_boxes, out_valid, allowed=None):
    """The pairs of the reference's valid answers and the program's, and
    per answer of either side whether it found none (1.0) or one (0.0)."""
    ob = out_boxes.float()
    ok = ref_valid[..., :, None] & out_valid[..., None, :]
    if allowed is not None:
        ok = ok & allowed
    pairs = _pairs(torch.where(ok, rc.iou(ref_boxes[..., :, None, :], ob[..., None, :, :]),
                               -1.0))
    miss = torch.cat([(~pairs.any(-1))[ref_valid], (~pairs.any(-2))[out_valid]]).float()
    return pairs, miss


def _e2e_items(ref, out, size: float):
    """The unconditioned items of one call: the reference's own answers
    ``ref`` against the program's ``out``."""
    miss, box = [], []
    for kind in ("person", "face"):
        rb, ob = ref[f"{kind}_boxes"], out[f"{kind}_boxes"]
        pairs, m = _paired(rb, ref[f"{kind}_valid"], ob, out[f"{kind}_valid"])
        miss.append(m)
        box.append(((rb[..., :, None, :] - ob.float()[..., None, :, :]).abs().amax(-1)
                    / size)[pairs])
    miss.append(_paired(ref["person_boxes"], ref["person_valid"] & ref["person_gated"],
                        out["person_boxes"], out["person_valid"] & out["person_gated"])[1])
    same = ref["pose_image_idx"][:, None] == out["pose_image_idx"][None, :]
    miss.append(_paired(ref["pose_boxes"], ref["pose_valid"], out["pose_boxes"],
                        out["pose_valid"], same)[1])
    return torch.cat(miss), torch.cat(box)


@torch.no_grad()
def judge(models, cfg: dict, frames_u8: torch.Tensor, gallery: torch.Tensor, out: Dict,
          face_capacity: int, pose_capacity: int, block: int = 16, cands=None
          ) -> Dict[str, torch.Tensor]:
    """The judged items of one call's answers ``out`` (the program's field
    names, on the reference's device) against the fp32 reference
    ``models``, on the host. ``cands`` (detector -> (boxes, scores)) reuses
    candidates of these frames."""
    c = cfg["cascade"]
    frames = frames_u8.float() / 255.0
    size = float(max(frames.shape[1:3]))
    if cands is None:
        cands = {n: rc.candidates(models[n], frames, block) for n in ("person_yolo", "face_yolo")}
    det = [_det_items(*cands["person_yolo"], out["person_boxes"], out["person_scores"],
                      out["person_valid"], c, size),
           _det_items(*cands["face_yolo"], out["face_boxes"], out["face_scores"],
                      out["face_valid"], c, size)]
    pose_gap, pose_score_err = _pose_items(models, frames, out, cfg["pose"], block * 2)
    ref = rc.ReferenceCascade(cfg, models, block).run(frames_u8, gallery, pose_capacity,
                                                      face_capacity, cands)
    e2e_miss, e2e_box_err = _e2e_items(ref, out, size)
    items = {
        "det_err": torch.cat([d[0] for d in det]),
        "nms_gap": torch.cat([d[1] for d in det]),
        "face_gap": _face_items(models, frames, gallery.float(), out, c, face_capacity,
                                block * 4),
        "pose_gap": pose_gap,
        "pose_score_err": pose_score_err,
        "structure": torch.tensor([float(_structure(out, c, face_capacity, pose_capacity))]),
        "e2e_miss": e2e_miss, "e2e_box_err": e2e_box_err,
    }
    return {k: v.float().cpu() for k, v in items.items()}


def numbers(items) -> Dict[str, Optional[float]]:
    """The check's numbers from the items of every judged call: the
    ``QUANTILE`` of each error, the mean of each share (None where nothing
    was judged: a stage that saw no work proves nothing), the sum of the
    structure counts."""
    cat = {k: torch.cat([i[k] for i in items]) for k in NUMBERS}
    read = lambda k, v: float(v.mean() if k in SHARES else torch.quantile(v, QUANTILE))  # noqa: E731
    out = {k: (read(k, v) if v.numel() else None) for k, v in cat.items() if k != "structure"}
    out["structure"] = float(cat["structure"].sum())
    return out


def spread(items) -> Dict[str, list]:
    """The 50th, 75th, 90th and 99th percentiles of each error, for the log."""
    q = torch.tensor([0.5, 0.75, 0.9, 0.99])
    cat = {k: torch.cat([i[k] for i in items]) for k in NUMBERS
           if k != "structure" and k not in SHARES}
    return {k: [round(float(x), 5) for x in torch.quantile(v, q)] if v.numel() else []
            for k, v in cat.items()}


def counts(items) -> Dict[str, int]:
    """How many items each number was read from."""
    return {k: sum(int(i[k].numel()) for i in items) for k in NUMBERS if k != "structure"}
