"""The face-gated pose cascade in plain fp32 torch.

The semantics are the original repository's serving cascade as the
program's docstrings state them (``infer/cascade.py``): detect persons and
faces with two YOLOv11-n detectors (DFL decode, confidence gate, top-K
candidates, greedy NMS, ``max_det`` kept), embed the top-F faces of the
batch with IR-50 (112x112 crops, [-1, 1], BGR), match them against the
gallery by cosine similarity, gate each person by a matched face whose centre
lies in its box, and run ViTPose on the top-G gated persons (256x192 crops,
ImageNet normalisation), decoding each heatmap by its first argmax plus a
quarter-pixel shift toward the larger neighbour, scored by the softmax
maximum times a box-size weight.

Everything here is written anew: plain loops and gathers where the program
has kernels, interpolation matrices and static compactions. The stage
functions are what :mod:`benchmark.reference.judge` uses to follow the
program's own decisions; :meth:`ReferenceCascade.run` chains them into a
whole cascade (the control, and the CPU tests).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.nets import TIRNet, TYolo
from benchmark.reference.precision import fp8, to_fp8
from benchmark.reference.vitpose import ViTPose

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
STRIDES = (8, 16, 32)
REG_MAX = 16


def meta_models(cfg: dict) -> Dict[str, torch.nn.Module]:
    """The four reference models of configuration ``cfg``, shapes only."""
    y, p = cfg["yolo"], cfg["pose"]
    with torch.device("meta"):
        return {
            "person_yolo": TYolo(1, tuple(y["width"]), tuple(y["depth"]), tuple(y["csp"])),
            "face_yolo": TYolo(1, tuple(y["width"]), tuple(y["depth"]), tuple(y["csp"])),
            "irnet": TIRNet(num_layers=cfg["irnet"]["layers"]),
            "vitpose": ViTPose(tuple(p["input_size"]), p["num_keypoints"], p["hidden"],
                               p["layers"], p["heads"], p["mlp_ratio"], p["patch_size"],
                               p["decoder_scale_factor"]),
        }


def build_models(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], device,
                 low: bool = False) -> Dict[str, torch.nn.Module]:
    """The reference models of ``cfg`` that ``weights`` holds (model name ->
    state dict under the reference's key names) on ``device``; ``low``
    switches them to the control's float8."""
    models = {k: m for k, m in meta_models(cfg).items() if k in weights}
    for name, m in models.items():
        m.to_empty(device=device)
        missing, unexpected = m.load_state_dict(weights[name], strict=False)
        # torch's BatchNorm counts its batches; nothing reads the count in eval
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError(f"reference {name}: missing {missing[:4]}, "
                             f"unexpected {unexpected[:4]}")
        m.eval()
        if low:
            to_fp8(m)
    return models


@torch.no_grad()
def calibrate(models, frames: torch.Tensor, cfg: dict) -> None:
    """Set every BatchNorm's statistics to those of real inputs, so that
    seeded random networks behave as trained ones do (unit-scale activations,
    spread scores and boxes, embeddings that tell faces apart): both
    detectors over ``frames`` (NHWC in [0, 1]), IR-50 over the crops of the
    faces the calibrated face detector finds there."""
    def stats_of(model, x):
        model.eval()
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_running_stats()
                m.momentum = None  # a cumulative average: one batch, its statistics
                m.train()
        model(x)
        model.eval()

    for name in ("person_yolo", "face_yolo"):
        stats_of(models[name], frames.permute(0, 3, 1, 2))
    c = cfg["cascade"]
    boxes, scores = candidates(models["face_yolo"], frames, frames.shape[0])
    faces = greedy_nms(boxes, scores, c["conf_threshold"], c["iou_threshold"],
                       c["pre_nms_top_k"], c["max_faces"])
    n = faces["boxes"].shape[1]
    idx = torch.arange(frames.shape[0], device=frames.device).repeat_interleave(n)
    crops = ((crop(frames, faces["boxes"].reshape(-1, 4), idx, (112, 112)) - 0.5) / 0.5).flip(-1)
    stats_of(models["irnet"], crops.permute(0, 3, 1, 2))


# ---- detection ---------------------------------------------------------------

def decode(maps, low: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw NCHW level maps -> xyxy pixel boxes (B, A, 4) and scores (B, A):
    per side a softmax over 16 bins and its expectation, offsets from the
    cell centres, times the stride; the class score is a sigmoid."""
    boxes, scores = [], []
    for x, stride in zip(maps, STRIDES):
        if low:
            x = fp8(x)
        b, _, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)  # (B, h*w, 64 + 1)
        dist = torch.softmax(x[..., :4 * REG_MAX].reshape(b, h * w, 4, REG_MAX), dim=-1)
        dist = (dist * torch.arange(REG_MAX, dtype=x.dtype, device=x.device)).sum(-1)
        gy, gx = torch.meshgrid(torch.arange(h, device=x.device, dtype=x.dtype) + 0.5,
                                torch.arange(w, device=x.device, dtype=x.dtype) + 0.5,
                                indexing="ij")
        centre = torch.stack([gx, gy], -1).reshape(1, h * w, 2)
        boxes.append(torch.cat([centre - dist[..., :2], centre + dist[..., 2:]], -1) * stride)
        scores.append(torch.sigmoid(x[..., 4 * REG_MAX]))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


@torch.no_grad()
def candidates(yolo, frames: torch.Tensor, block: int, low: bool = False):
    """Decoded candidates of every anchor for NHWC ``frames`` in [0, 1],
    ``block`` frames at a time."""
    out = [decode(yolo(f.permute(0, 3, 1, 2)), low) for f in frames.split(block)]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes broadcast against each other (eps 1e-7 in the union)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda x: (x[..., 2:] - x[..., :2]).clamp(min=0).prod(-1)  # noqa: E731
    return inter / (area(a) + area(b) - inter + 1e-7)


def top_by_score(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best along the last axis, ties to the lower index."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def greedy_nms(boxes, scores, conf: float, iou_threshold: float, top_k: int, max_det: int):
    """Per image: candidates above ``conf``, the ``top_k`` best, then greedy
    suppression (IoU above the threshold) in score order; the first
    ``max_det`` kept. -> boxes (B, max_det, 4), scores, valid."""
    b = boxes.shape[0]
    gated = torch.where(scores > conf, scores, torch.full_like(scores, float("-inf")))
    s, idx = top_by_score(gated, min(top_k, scores.shape[1]))
    bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    live = torch.isfinite(s)
    kept = torch.zeros_like(live)
    for i in range(s.shape[1]):
        keep_i = live[:, i] & (kept.sum(1) < max_det)
        kept[:, i] = keep_i
        live &= ~(keep_i[:, None] & (iou(bx[:, i:i + 1], bx) > iou_threshold))
    order = torch.sort(kept.to(torch.int8), dim=1, descending=True,
                       stable=True).indices[:, :max_det]
    valid = torch.gather(kept, 1, order)
    out_s = torch.where(valid, torch.gather(s, 1, order), 0.0)
    out_b = torch.gather(bx, 1, order[..., None].expand(-1, -1, 4)) * valid[..., None]
    if out_s.shape[1] < max_det:
        pad = max_det - out_s.shape[1]
        out_b, out_s = F.pad(out_b, (0, 0, 0, pad)), F.pad(out_s, (0, pad))
        valid = F.pad(valid, (0, pad))
    return {"boxes": out_b, "scores": out_s, "valid": valid[:b]}


# ---- crops, faces, gate, pose ----------------------------------------------

def crop(frames: torch.Tensor, boxes: torch.Tensor, image_idx: torch.Tensor,
         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear crops (K, oh, ow, C) of NHWC ``frames``: sample centres at
    ``x1 + (j + 0.5) / ow * w - 0.5`` (width at least 1e-3), clipped to the
    image, each the blend of its four neighbours."""
    h, w = frames.shape[1:3]
    oh, ow = out_hw
    boxes = boxes.float()
    bw = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-3)
    bh = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-3)
    def ar(n):
        return (torch.arange(n, device=boxes.device, dtype=torch.float32) + 0.5) / n

    sy = (boxes[:, 1:2] + ar(oh) * bh[:, None] - 0.5).clamp(0, h - 1)
    sx = (boxes[:, 0:1] + ar(ow) * bw[:, None] - 0.5).clamp(0, w - 1)
    y0, x0 = sy.floor().long(), sx.floor().long()
    y1, x1 = (y0 + 1).clamp(max=h - 1), (x0 + 1).clamp(max=w - 1)
    fy, fx = (sy - y0)[:, :, None, None], (sx - x0)[:, None, :, None]
    n = image_idx[:, None, None]
    at = lambda yy, xx: frames[n, yy[:, :, None], xx[:, None, :]]  # noqa: E731
    top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
    bottom = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
    return top * (1 - fy) + bottom * fy


@torch.no_grad()
def embed(irnet, frames, boxes, image_idx, block: int) -> torch.Tensor:
    """Unit IR-50 embeddings (K, 512) of face boxes: 112x112 crops mapped to
    [-1, 1] with the channels in BGR order, as AdaFace was trained."""
    out = []
    for bx, ix in zip(boxes.split(block), image_idx.split(block)):
        c = ((crop(frames, bx, ix, (112, 112)) - 0.5) / 0.5).flip(-1)
        out.append(irnet(c.permute(0, 3, 1, 2))[0])
    return torch.cat(out) if out else boxes.new_zeros(0, 512)


@torch.no_grad()
def heatmaps(vit, frames, boxes, image_idx, input_size, block: int) -> torch.Tensor:
    """ViTPose heatmaps (G, K, H, W) of person boxes."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    out = []
    for bx, ix in zip(boxes.split(block), image_idx.split(block)):
        c = (crop(frames, bx, ix, tuple(input_size)) - mean) / std
        out.append(vit(c.permute(0, 3, 1, 2)).float())
    return torch.cat(out)


def keypoint_scores(hm: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Per keypoint: the softmax maximum of its heatmap times
    clip(sqrt(box area) / 96, 0.5, 2)."""
    g, k = hm.shape[:2]
    prob = torch.softmax(hm.reshape(g, k, -1), -1).amax(-1)
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).clamp(min=0)
    return prob * (area.sqrt() / 96.0).clamp(0.5, 2.0)[:, None]


def decode_keypoints(hm: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Image-pixel keypoints (G, K, 2): the first argmax cell of each heatmap,
    its centre moved a quarter cell toward the larger neighbour on each
    axis, mapped from the heatmap onto the box."""
    g, k, h, w = hm.shape
    idx = hm.reshape(g, k, -1).argmax(-1)
    iy, ix = idx // w, idx % w
    at = lambda yy, xx: hm[torch.arange(g, device=hm.device)[:, None],  # noqa: E731
                           torch.arange(k, device=hm.device)[None, :],
                           yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
    x = ix + 0.5 + 0.25 * torch.sign(at(iy, ix + 1) - at(iy, ix - 1))
    y = iy + 0.5 + 0.25 * torch.sign(at(iy + 1, ix) - at(iy - 1, ix))
    bw, bh = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    return torch.stack([x / w * bw[:, None] + boxes[:, 0:1],
                        y / h * bh[:, None] + boxes[:, 1:2]], -1)


def face_slots(face_scores, face_valid, capacity: int):
    """The top-``capacity`` valid faces of the batch by score (ties to the
    lower flat index) -> flat indices (F,) and their validity."""
    flat = torch.where(face_valid, face_scores.float(),
                       torch.full_like(face_scores.float(), float("-inf"))).reshape(-1)
    s, idx = top_by_score(flat, capacity)
    return idx, torch.isfinite(s)


def gate(person_boxes, person_valid, face_boxes, face_valid, face_matched):
    """person gated = valid and some valid matched face's centre lies inside
    its box (edges included)."""
    cx = (face_boxes[..., 0] + face_boxes[..., 2]) / 2
    cy = (face_boxes[..., 1] + face_boxes[..., 3]) / 2
    pb = person_boxes[:, :, None, :]
    inside = ((cx[:, None] >= pb[..., 0]) & (cx[:, None] <= pb[..., 2])
              & (cy[:, None] >= pb[..., 1]) & (cy[:, None] <= pb[..., 3]))
    return (inside & (face_matched & face_valid)[:, None]).any(-1) & person_valid


def pose_slots(person_scores, gated, capacity: int):
    """The top-``capacity`` gated persons of the batch by score."""
    return face_slots(person_scores, gated, capacity)


class ReferenceCascade:
    """The whole cascade over the reference models of ``build_models``."""

    def __init__(self, cfg: dict, models, block: int = 16, low: bool = False):
        self.cfg, self.models, self.block, self.low = cfg, models, block, low

    @torch.no_grad()
    def run(self, frames_u8: torch.Tensor, gallery: torch.Tensor, pose_capacity: int,
            face_capacity: int, cands=None) -> Dict[str, torch.Tensor]:
        """The cascade's answers for uint8 NHWC frames, under the program's
        field names. ``cands`` (detector -> (boxes, scores)) reuses the
        candidates of these frames."""
        c = self.cfg["cascade"]
        frames = frames_u8.float() / 255.0
        b = frames.shape[0]
        det = {}
        for name, kmax in (("person_yolo", c["max_persons"]), ("face_yolo", c["max_faces"])):
            boxes, scores = (cands[name] if cands is not None else
                             candidates(self.models[name], frames, self.block, self.low))
            det[name] = greedy_nms(boxes, scores, c["conf_threshold"], c["iou_threshold"],
                                   c["pre_nms_top_k"], kmax)
        persons, faces = det["person_yolo"], det["face_yolo"]
        kf, kp = c["max_faces"], c["max_persons"]
        f_idx, f_valid = face_slots(faces["scores"], faces["valid"], face_capacity)
        emb = embed(self.models["irnet"], frames, faces["boxes"].reshape(-1, 4)[f_idx],
                    f_idx // kf, self.block * 4)
        sims = emb @ gallery.float().T
        best = torch.where(f_valid, sims.amax(-1), torch.full_like(f_valid, -1.0, dtype=sims.dtype))
        sim = torch.full((b * kf,), -1.0, device=frames.device)
        sim[f_idx] = best
        ident = torch.zeros(b * kf, dtype=torch.int64, device=frames.device)
        ident[f_idx] = sims.argmax(-1)
        sim, ident = sim.reshape(b, kf), ident.reshape(b, kf)
        matched = (sim > c["match_threshold"]) & faces["valid"]
        gated = gate(persons["boxes"], persons["valid"], faces["boxes"], faces["valid"], matched)
        p_idx, p_valid = pose_slots(persons["scores"], gated, pose_capacity)
        p_boxes = persons["boxes"].reshape(-1, 4)[p_idx]
        hm = heatmaps(self.models["vitpose"], frames, p_boxes, p_idx // kp,
                      self.cfg["pose"]["input_size"], self.block * 2)
        if self.low:
            hm = fp8(hm)
        return {
            "person_boxes": persons["boxes"], "person_scores": persons["scores"],
            "person_valid": persons["valid"],
            "face_boxes": faces["boxes"], "face_scores": faces["scores"],
            "face_valid": faces["valid"],
            "face_identity": torch.where(matched, ident, torch.full_like(ident, -1)),
            "face_similarity": sim, "person_gated": gated,
            "pose_image_idx": torch.where(p_valid, p_idx // kp, torch.full_like(p_idx, -1)),
            "pose_boxes": p_boxes, "pose_valid": p_valid,
            "pose_keypoints": decode_keypoints(hm, p_boxes),
            "pose_scores": keypoint_scores(hm, p_boxes) * p_valid[:, None],
        }
