"""The comparison that decides ``correct`` for the cascade with RT-DETR as its
person detector (``cascade_rtdetr.py``).

The persons are judged the way ``judge.py`` judges everything else: by
following the program's own decisions. The reference runs RT-DETR's
backbone and encoder in fp32 on the frames, then

- ``sel_gap`` (per frame): the query selection replayed on the reference's
  encoder logits (each anchor's largest class logit): how far the best
  anchor the program left out lies above the worst of the program's
  ``num_queries`` picks, in units of the frame's logit standard deviation,
  less ``SEL_BAND`` (near-ties at the cut go either way in bfloat16);
- ``dec_err`` (per served person): the reference decoder run on the
  program's selected anchors: the larger of the person score's error and
  the box's largest coordinate error over the image size, at the query the
  program served;
- ``person_gap`` (per frame): the top ``max_persons`` replayed on the
  reference decoder's person scores with the program's picks, as
  ``judge.py``'s ``nms_gap`` without the IoU term: at each rank, how far the
  best query still free lies above the program's pick (or above the
  confidence gate where the program served nothing, or the gate above a
  pick it served).

The face detector, the face stage and the pose stage are judged as in
``judge.py`` (``det_err`` and ``nms_gap`` on the faces alone, ``face_gap``,
``pose_gap``, ``pose_score_err``), and so are ``structure`` (with two more
checks: every served person lies above the gate, in order of score) and the
unconditioned ``e2e_miss`` and ``e2e_box_err`` against the reference's own
whole cascade.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import cascade as rc
from benchmark.reference import cascade_rtdetr as rcr
from benchmark.reference import judge as j
from benchmark.reference import rtdetr as R

# half a standard deviation of the frame's logits: bf16's near-ties at the
# cut (its encoder logits lie 0.15 of one from fp32's on average) read 0
SEL_BAND = 0.5
NUMBERS = ("sel_gap", "dec_err", "person_gap", "det_err", "nms_gap", "face_gap", "pose_gap",
           "pose_score_err", "structure", "e2e_miss", "e2e_box_err")


def _xyxy(boxes: torch.Tensor, size: float) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) * size


@torch.no_grad()
def person_items(model, cfg: dict, frames: torch.Tensor, out: Dict, size: float, block: int):
    """The persons' items of one call, and the reference RT-DETR's own
    outputs on the frames (its logits, boxes and anchors, for the whole
    cascade)."""
    c = cfg["cascade"]
    thr, kp = c["conf_threshold"], c["max_persons"]
    label = cfg["rtdetr"]["person_label"]
    dec = model.decoder
    sel, err, gaps, own = [], [], [], []
    for start in range(0, frames.shape[0], block):
        sl = slice(start, start + block)
        x = frames[sl].permute(0, 3, 1, 2)
        memory, shapes = dec.encoder_input(model.encoder(model.backbone(x)))
        output_memory, logits, coords = dec.encoder_heads(memory, shapes)
        score = logits.amax(-1)
        idx = out["person_anchor_idx"][sl]
        picked = torch.zeros_like(score, dtype=torch.bool).scatter_(1, idx, True)
        worst_in = score.gather(1, idx).amin(1)
        best_out = torch.where(picked, float("-inf"), score).amax(1)
        sel.append(((best_out - worst_in) / score.std(1).clamp(min=1e-6) - SEL_BAND).clamp(min=0))

        lg, bx = dec.decode(*dec.select(output_memory, coords, idx), memory, shapes)
        ref_s = torch.sigmoid(lg[..., label])
        ref_b = _xyxy(bx, size)
        q, v = out["person_query_idx"][sl], out["person_valid"][sl]
        pick_s = ref_s.gather(1, q)
        pick_b = ref_b.gather(1, q[..., None].expand(-1, -1, 4))
        e = torch.maximum((out["person_scores"][sl].float() - pick_s).abs(),
                          (out["person_boxes"][sl].float() - pick_b).abs().amax(-1) / size)
        err.append(e[v])

        free = ref_s > thr
        gap = torch.zeros(q.shape[0], device=q.device)
        rows = torch.arange(q.shape[0], device=q.device)
        for r in range(kp):
            has = free.any(1)
            best = torch.where(free, ref_s, float("-inf")).amax(1)
            vr = v[:, r]
            gap = torch.maximum(gap, torch.where(vr, (torch.where(has, best, thr)
                                                      - pick_s[:, r]).clamp(min=0), 0.0))
            gap = torch.maximum(gap, torch.where(~vr & has, best - thr, 0.0))
            free[rows, q[:, r]] &= ~vr
        gaps.append(gap)

        own_idx = R.top_queries(logits, dec.num_queries)
        own.append((*dec.decode(*dec.select(output_memory, coords, own_idx), memory, shapes),
                    own_idx))
        del memory, output_memory, logits, coords
    ref_out = tuple(torch.cat([o[i] for o in own]) for i in range(3))
    return torch.cat(sel), torch.cat(err), torch.cat(gaps), ref_out


def _structure(out, c, face_capacity: int, pose_capacity: int) -> int:
    """``judge.py``'s structure count, and the served persons that lie at or
    below the gate or out of score order."""
    s, v = out["person_scores"].float(), out["person_valid"]
    bad = int((v & (s <= c["conf_threshold"])).sum())
    bad += int(((s[:, 1:] > s[:, :-1]) & v[:, 1:]).sum())
    return bad + j._structure(out, c, face_capacity, pose_capacity)


@torch.no_grad()
def judge(models, cfg: dict, frames_u8: torch.Tensor, gallery: torch.Tensor, out: Dict,
          face_capacity: int, pose_capacity: int, block: int = 16, face_cands=None
          ) -> Dict[str, torch.Tensor]:
    """The judged items of one call's answers ``out`` (the program's field
    names, with ``person_anchor_idx`` and ``person_query_idx``, on the
    reference's device) against the fp32 reference ``models``, on the host.
    ``face_cands`` reuses the face detector's candidates of these frames."""
    c = cfg["cascade"]
    frames = frames_u8.float() / 255.0
    size = float(max(frames.shape[1:3]))
    if face_cands is None:
        face_cands = rc.candidates(models["face_yolo"], frames, block)
    sel_gap, dec_err, person_gap, ref_rtdetr = person_items(
        models["person_rtdetr"], cfg, frames, out, size, block)
    det_err, nms_gap = j._det_items(*face_cands, out["face_boxes"], out["face_scores"],
                                    out["face_valid"], c, size)
    pose_gap, pose_score_err = j._pose_items(models, frames, out, cfg["pose"], block * 2)
    ref = rcr.ReferenceCascade(cfg, models, block).run(
        frames_u8, gallery, pose_capacity, face_capacity,
        {"person_rtdetr": ref_rtdetr, "face_yolo": face_cands})
    e2e_miss, e2e_box_err = j._e2e_items(ref, out, size)
    items = {
        "sel_gap": sel_gap, "dec_err": dec_err, "person_gap": person_gap,
        "det_err": det_err, "nms_gap": nms_gap,
        "face_gap": j._face_items(models, frames, gallery.float(), out, c, face_capacity,
                                  block * 4),
        "pose_gap": pose_gap, "pose_score_err": pose_score_err,
        "structure": torch.tensor([float(_structure(out, c, face_capacity, pose_capacity))]),
        "e2e_miss": e2e_miss, "e2e_box_err": e2e_box_err,
    }
    return {k: v.float().cpu() for k, v in items.items()}


def numbers(items) -> Dict[str, Optional[float]]:
    """``judge.py::numbers`` over this judge's numbers."""
    cat = {k: torch.cat([i[k] for i in items]) for k in NUMBERS}
    out = {k: (float(v.mean() if k in j.SHARES else torch.quantile(v, j.QUANTILE))
               if v.numel() else None) for k, v in cat.items() if k != "structure"}
    out["structure"] = float(cat["structure"].sum())
    return out


def spread(items) -> Dict[str, list]:
    """The 50th, 75th, 90th and 99th percentiles of each error, for the log."""
    q = torch.tensor([0.5, 0.75, 0.9, 0.99])
    return {k: [round(float(x), 5) for x in torch.quantile(torch.cat([i[k] for i in items]), q)]
            if sum(i[k].numel() for i in items) else []
            for k in NUMBERS if k != "structure" and k not in j.SHARES}


def counts(items) -> Dict[str, int]:
    """How many items each number was read from."""
    return {k: sum(int(i[k].numel()) for i in items) for k in NUMBERS if k != "structure"}
