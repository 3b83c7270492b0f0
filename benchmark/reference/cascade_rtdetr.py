"""The face-gated pose cascade with RT-DETR-R50 as its person detector, in
plain fp32 torch.

The same cascade as ``cascade.py`` (whose face detection, crops, gallery
match, gate, pose slots and heatmap decoding it reuses), with the persons
detected as the program's docstrings state it (``infer/cascade.py``,
``person_detector="rtdetr"``): RT-DETR's last decoder layer, the sigmoid of
its person column, the confidence gate and the top ``max_persons`` queries,
no NMS (``rtdetr.py::persons``).
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference import cascade as rc
from benchmark.reference import rtdetr as R
from benchmark.reference.nets import TIRNet, TYolo
from benchmark.reference.precision import fp8, to_fp8
from benchmark.reference.vitpose import ViTPose


def rtdetr_kwargs(cfg: dict) -> dict:
    r = cfg["rtdetr"]
    return {"num_classes": r["num_classes"], "dim": r["hidden"], "num_queries": r["num_queries"],
            "heads": r["heads"], "ffn": r["ffn"], "levels": r["levels"], "points": r["points"],
            "num_layers": r["num_decoder_layers"]}


def meta_models(cfg: dict) -> Dict[str, torch.nn.Module]:
    """The four reference models of configuration ``cfg``, shapes only."""
    y, p = cfg["yolo"], cfg["pose"]
    with torch.device("meta"):
        return {
            "person_rtdetr": R.RTDETR(**rtdetr_kwargs(cfg)),
            "face_yolo": TYolo(1, tuple(y["width"]), tuple(y["depth"]), tuple(y["csp"])),
            "irnet": TIRNet(num_layers=cfg["irnet"]["layers"]),
            "vitpose": ViTPose(tuple(p["input_size"]), p["num_keypoints"], p["hidden"],
                               p["layers"], p["heads"], p["mlp_ratio"], p["patch_size"],
                               p["decoder_scale_factor"]),
        }


def build_models(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], device,
                 low: bool = False) -> Dict[str, torch.nn.Module]:
    """The reference models of ``cfg`` that ``weights`` holds, on ``device``;
    ``low`` switches them to the control's float8."""
    models = {k: m for k, m in meta_models(cfg).items() if k in weights}
    for name, m in models.items():
        m.to_empty(device=device)
        missing, unexpected = m.load_state_dict(weights[name], strict=False)
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
    """Every BatchNorm's statistics from real inputs (``cascade.py::
    calibrate``'s way): RT-DETR and the face detector over ``frames`` (NHWC
    in [0, 1]), IR-50 over the crops of the faces the calibrated face
    detector finds there; then RT-DETR's person bias
    (:func:`calibrate_person_bias`)."""
    def stats_of(model, run):
        model.eval()
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.reset_running_stats()
                m.momentum = None
                m.train()
        run()
        model.eval()

    x = frames.permute(0, 3, 1, 2)
    stats_of(models["person_rtdetr"], lambda: R.detect(models["person_rtdetr"], x))
    calibrate_person_bias(models["person_rtdetr"], x, cfg)
    stats_of(models["face_yolo"], lambda: models["face_yolo"](x))
    c = cfg["cascade"]
    boxes, scores = rc.candidates(models["face_yolo"], frames, frames.shape[0])
    faces = rc.greedy_nms(boxes, scores, c["conf_threshold"], c["iou_threshold"],
                          c["pre_nms_top_k"], c["max_faces"])
    n = faces["boxes"].shape[1]
    idx = torch.arange(frames.shape[0], device=frames.device).repeat_interleave(n)
    crops = ((rc.crop(frames, faces["boxes"].reshape(-1, 4), idx, (112, 112)) - 0.5)
             / 0.5).flip(-1)
    stats_of(models["irnet"], lambda: models["irnet"](crops.permute(0, 3, 1, 2)))


def person_bias_key(cfg: dict) -> str:
    """The state-dict key of the last decoder layer's class bias."""
    return f"decoder.dec_score_head.{cfg['rtdetr']['num_decoder_layers'] - 1}.bias"


@torch.no_grad()
def calibrate_person_bias(model, x: torch.Tensor, cfg: dict) -> None:
    """Shift the person column's bias of the last decoder layer so that the
    ``init["rtdetr_person_quantile"]`` quantile of its logits over the
    queries of frames ``x`` (NCHW) is 0, a score of 0.5: a random network's
    person logits share an offset that varies from seed to seed by more
    than they vary between queries, which would serve all persons of one
    seed and none of another."""
    label = cfg["rtdetr"]["person_label"]
    logits = R.detect(model, x)[0][..., label]
    head = model.decoder.dec_score_head[-1]
    head.bias[label] -= torch.quantile(logits.flatten(), cfg["init"]["rtdetr_person_quantile"])


@torch.no_grad()
def detect(model, frames: torch.Tensor, block: int):
    """RT-DETR's last-layer logits, boxes and selected anchors for NHWC
    ``frames`` in [0, 1], ``block`` frames at a time."""
    out = [R.detect(model, f.permute(0, 3, 1, 2)) for f in frames.split(block)]
    return tuple(torch.cat([o[i] for o in out]) for i in range(3))


def persons(cfg: dict, logits, boxes, size: float) -> Dict[str, torch.Tensor]:
    """The served persons of RT-DETR's outputs (``rtdetr.py::persons``)."""
    c = cfg["cascade"]
    label = cfg["rtdetr"]["person_label"]
    return R.persons(logits[..., label:label + 1], boxes, c["conf_threshold"],
                     c["max_persons"], size)


class ReferenceCascade:
    """The whole cascade over the reference models of ``build_models``."""

    def __init__(self, cfg: dict, models, block: int = 16, low: bool = False):
        self.cfg, self.models, self.block, self.low = cfg, models, block, low

    @torch.no_grad()
    def run(self, frames_u8: torch.Tensor, gallery: torch.Tensor, pose_capacity: int,
            face_capacity: int, cands=None) -> Dict[str, torch.Tensor]:
        """The cascade's answers for uint8 NHWC frames, under the program's
        field names (with the persons' anchors and queries). ``cands``
        reuses these frames' RT-DETR outputs (``person_rtdetr``) and face
        candidates (``face_yolo``)."""
        c = self.cfg["cascade"]
        frames = frames_u8.float() / 255.0
        b = frames.shape[0]
        size = float(frames.shape[2])
        logits, boxes, anchors = (cands["person_rtdetr"] if cands is not None else
                                  detect(self.models["person_rtdetr"], frames, self.block))
        persons_ = persons(self.cfg, logits, boxes, size)
        fb, fs = (cands["face_yolo"] if cands is not None else
                  rc.candidates(self.models["face_yolo"], frames, self.block, self.low))
        faces = rc.greedy_nms(fb, fs, c["conf_threshold"], c["iou_threshold"],
                              c["pre_nms_top_k"], c["max_faces"])
        kf, kp = c["max_faces"], c["max_persons"]
        f_idx, f_valid = rc.face_slots(faces["scores"], faces["valid"], face_capacity)
        emb = rc.embed(self.models["irnet"], frames, faces["boxes"].reshape(-1, 4)[f_idx],
                       f_idx // kf, self.block * 4)
        sims = emb @ gallery.float().T
        best = torch.where(f_valid, sims.amax(-1),
                           torch.full_like(f_valid, -1.0, dtype=sims.dtype))
        sim = torch.full((b * kf,), -1.0, device=frames.device)
        sim[f_idx] = best
        ident = torch.zeros(b * kf, dtype=torch.int64, device=frames.device)
        ident[f_idx] = sims.argmax(-1)
        sim, ident = sim.reshape(b, kf), ident.reshape(b, kf)
        matched = (sim > c["match_threshold"]) & faces["valid"]
        gated = rc.gate(persons_["boxes"], persons_["valid"], faces["boxes"], faces["valid"],
                        matched)
        p_idx, p_valid = rc.pose_slots(persons_["scores"], gated, pose_capacity)
        p_boxes = persons_["boxes"].reshape(-1, 4)[p_idx]
        hm = rc.heatmaps(self.models["vitpose"], frames, p_boxes, p_idx // kp,
                         self.cfg["pose"]["input_size"], self.block * 2)
        if self.low:
            hm = fp8(hm)
        return {
            "person_boxes": persons_["boxes"], "person_scores": persons_["scores"],
            "person_valid": persons_["valid"],
            "face_boxes": faces["boxes"], "face_scores": faces["scores"],
            "face_valid": faces["valid"],
            "face_identity": torch.where(matched, ident, torch.full_like(ident, -1)),
            "face_similarity": sim, "person_gated": gated,
            "pose_image_idx": torch.where(p_valid, p_idx // kp, torch.full_like(p_idx, -1)),
            "pose_boxes": p_boxes, "pose_valid": p_valid,
            "pose_keypoints": rc.decode_keypoints(hm, p_boxes),
            "pose_scores": rc.keypoint_scores(hm, p_boxes) * p_valid[:, None],
            "person_anchor_idx": anchors, "person_query_idx": persons_["queries"],
        }
