"""The face-gated pose cascade (``prpe_tpu/infer/cascade.py``): detect persons
and faces -> embed the top-F faces -> cosine match against a gallery -> gate
persons by a matched face inside their box -> pose only the top-G gated
persons.

Every shape is static (top-F and top-G compactions with validity masks in
place of data-dependent branches), so a later change can capture the runner
in a CUDA graph. The kernels of the path are the greedy NMS (twice per
call) and, once per ViT block, the attention kernel that ``PRPE_ATTN_MODE``
selects (``nn/vit.py``): the packed MHSA by default.

The person detector is a YOLOv11 by default (``person_detector="yolo"``)
or RT-DETR (``"rtdetr"``, ``nn/rtdetr.py``), which needs no decode and no
NMS: the sigmoid of its person column over the last decoder layer's
queries, the confidence gate, the stable top-``max_persons`` and the boxes
from cxcywh to xyxy pixels, in static shapes; its runner's results carry
the anchors the detector selected and the query of each served person
(:class:`RTDETRCascadeResult`). RT-DETR adds one deformable-attention
kernel a decoder layer (``ops/kernels/ms_deform_attn.py``).

While a ``torch.profiler`` records, each call keeps its stage spans (host
and device time) and the counters of its gating funnel
(``utils/profiling.py``); otherwise they cost one branch a call.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig, RTDETRConfig
from prpe_tpu_torch.core.device import resolve_device
from prpe_tpu_torch.nn.common import materialize
from prpe_tpu_torch.nn.irnet import IRNet
from prpe_tpu_torch.nn.rtdetr import RTDETR
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.nn.yolo import YOLO, decode_predictions
from prpe_tpu_torch.ops.boxes import cxcywh_to_xyxy
from prpe_tpu_torch.ops.heatmap import decode_heatmaps, flip_heatmaps
from prpe_tpu_torch.ops.nms import Detections, non_max_suppression, topk_stable
from prpe_tpu_torch.ops.roi import crop_and_resize_batch
from prpe_tpu_torch.utils import profiling

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


PERSON_DETECTORS = ("yolo", "rtdetr")


class CascadeModel(nn.Module):
    """The four component models of the cascade (the person and the face
    detector, IR-Net, ViTPose) with fp32 parameters and compute in ``dtype``.

    The person detector is a YOLOv11 (``person_yolo``) or, with
    ``person_detector="rtdetr"``, RT-DETR of ``rtdetr``'s widths
    (``person_rtdetr``); the face detector is a YOLOv11. Built on
    ``device`` (CUDA unless the caller names another) and filled from a
    ``torch.Generator`` seeded with ``seed``; load real weights with
    ``load_state_dict`` (see ``models/porting.py``).
    """

    def __init__(self, detection: DetectionConfig = DetectionConfig(),
                 pose_cfg: PoseConfig = PoseConfig(), irnet_layers: int = 50,
                 dtype: torch.dtype = torch.float32, *, device=None, seed: int = 0,
                 person_detector: str = "yolo", rtdetr: RTDETRConfig = RTDETRConfig()):
        super().__init__()
        if person_detector not in PERSON_DETECTORS:
            raise ValueError(f"person_detector {person_detector!r}: one of {PERSON_DETECTORS}")
        self.detection = detection
        self.pose_cfg = pose_cfg
        self.dtype = dtype
        self.person_detector = person_detector
        self.rtdetr_cfg = rtdetr
        dev = resolve_device(device)
        with torch.device("meta"):
            if person_detector == "yolo":
                self.person_yolo = YOLO(nc=1, variant=detection.variant, dtype=dtype)
            else:
                r = rtdetr
                self.person_rtdetr = RTDETR(
                    num_classes=r.num_classes, hidden=r.hidden, num_queries=r.num_queries,
                    heads=r.heads, ffn=r.ffn, levels=r.levels, points=r.points,
                    num_decoder_layers=r.num_decoder_layers, image_size=detection.image_size,
                    dtype=dtype)
            self.face_yolo = YOLO(nc=1, variant=detection.variant, dtype=dtype)
            self.irnet = IRNet(num_layers=irnet_layers, dtype=dtype)
            self.vitpose = ViTPose(
                image_size=pose_cfg.input_size, num_keypoints=pose_cfg.num_keypoints,
                hidden=pose_cfg.vit_hidden, layers=pose_cfg.vit_layers,
                heads=pose_cfg.vit_heads, mlp_ratio=pose_cfg.vit_mlp_ratio,
                patch_size=pose_cfg.patch_size, scale_factor=pose_cfg.decoder_scale_factor,
                dtype=dtype)
        materialize(self, dev, seed)

    @property
    def device(self) -> torch.device:
        return self.vitpose.backbone.pos_embed.device


class CascadeResult(NamedTuple):
    persons: Detections  # (B, Kp, ...)
    faces: Detections  # (B, Kf, ...)
    face_identity: torch.Tensor  # (B, Kf) best gallery index (-1 = no match)
    face_similarity: torch.Tensor  # (B, Kf) best cosine similarity (-1 outside top-F)
    person_gated: torch.Tensor  # (B, Kp) bool: matched identity inside the box
    face_budget_saturated: torch.Tensor  # () bool: valid faces exceeded top-F
    pose_image_idx: torch.Tensor  # (G,)
    pose_boxes: torch.Tensor  # (G, 4)
    pose_keypoints: torch.Tensor  # (G, K, 2) image pixels
    pose_scores: torch.Tensor  # (G, K)
    pose_valid: torch.Tensor  # (G,)


# the RT-DETR runner's results: a CascadeResult's fields, then the anchors
# the detector selected, (B, num_queries), and the query each person slot
# holds, (B, Kp) (padding slots hold one too)
RTDETRCascadeResult = NamedTuple("RTDETRCascadeResult", [
    *CascadeResult.__annotations__.items(),
    ("person_anchor_idx", torch.Tensor), ("person_query_idx", torch.Tensor)])


def _face_person_gate(person_det: Detections, face_det: Detections,
                      face_matched: torch.Tensor) -> torch.Tensor:
    """person_gated[b, i] = any matched face whose centre lies in person box i."""
    fcx = (face_det.boxes[..., 0] + face_det.boxes[..., 2]) / 2  # (B, Kf)
    fcy = (face_det.boxes[..., 1] + face_det.boxes[..., 3]) / 2
    pb = person_det.boxes  # (B, Kp, 4)
    inside = ((fcx[:, None, :] >= pb[..., 0:1]) & (fcx[:, None, :] <= pb[..., 2:3])
              & (fcy[:, None, :] >= pb[..., 1:2]) & (fcy[:, None, :] <= pb[..., 3:4]))
    ok = inside & face_matched[:, None, :] & face_det.valid[:, None, :]
    return ok.any(-1) & person_det.valid


def _unit_norm(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 pixels -> [0, 1] in ``dtype`` (``data/packed.py::apply_image_norm``
    with norm "unit": multiply by 1/255 in the model dtype)."""
    return images.to(dtype) * torch.tensor(1.0 / 255.0, dtype=dtype, device=images.device)


def build_cascade_runner(model: CascadeModel, cascade_cfg: CascadeConfig = CascadeConfig(), *,
                         pose_capacity: Optional[int] = None,
                         device=None) -> Callable[[torch.Tensor, torch.Tensor], CascadeResult]:
    """Returns ``run(images, gallery) -> CascadeResult``.

    ``images`` (B, S, S, 3) NHWC RGB in [0, 1] (fp32 or bf16) or uint8;
    ``gallery`` (N_ids, 512) L2-normalised identity embeddings. Both are
    moved to ``device`` (CUDA unless the caller names another), where the
    model must already live. With RT-DETR as the person detector ``run``
    returns an :class:`RTDETRCascadeResult`.
    """
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model is on {model.device}, runner on {dev}")
    if dev.type == "cuda" and model.dtype == torch.float32:
        # the fp32 path stays fp32 on the card: no TF32 in cuDNN convolutions
        # or cuBLAS matmuls (cuDNN's default would round inputs to TF32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    det = model.detection
    pose_cfg = model.pose_cfg
    kp, kf = cascade_cfg.max_persons, cascade_cfg.max_faces
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)

    def detect(yolo: YOLO, x: torch.Tensor, max_det: int, nms_k: int, tr,
               span: str) -> Detections:
        with tr.span(span):
            raw = yolo(x)
        return non_max_suppression(
            decode_predictions(raw, det.num_classes, det.reg_max),
            conf_threshold=cascade_cfg.conf_threshold, iou_threshold=det.iou_threshold,
            max_det=max_det, pre_nms_top_k=nms_k)

    rtdetr = model.person_detector == "rtdetr"

    def detect_rtdetr(x: torch.Tensor, tr):
        """RT-DETR's persons: the sigmoid of the person column over the
        queries, gated at the confidence threshold, the top ``kp`` of each
        frame (ties to the lower query), xyxy pixel boxes; and the output."""
        with tr.span("cascade.person_rtdetr"):
            out = model.person_rtdetr(x, tr.span)
            score = torch.sigmoid(out.logits[..., model.rtdetr_cfg.person_label])
            gated = torch.where(score > cascade_cfg.conf_threshold, score,
                                torch.tensor(float("-inf"), device=dev))
            top, query = topk_stable(gated, kp)
            valid = torch.isfinite(top)
            boxes = cxcywh_to_xyxy(torch.gather(out.boxes, 1, query[..., None].expand(-1, -1, 4)))
            boxes = boxes * torch.tensor([x.shape[2], x.shape[1]] * 2, device=dev)
            persons = Detections(
                boxes=torch.where(valid[..., None], boxes, torch.zeros_like(boxes)),
                scores=torch.where(valid, top, torch.zeros_like(top)),
                classes=torch.where(valid, model.rtdetr_cfg.person_label, -1).to(torch.int32),
                valid=valid)
        return persons, out.selected, query

    @torch.inference_mode()
    def run(images: torch.Tensor, gallery: torch.Tensor) -> CascadeResult:
        b = images.shape[0]
        with profiling.call("cascade.call", b, dev) as tr:
            return _run(images, gallery, b, tr)

    def _run(images: torch.Tensor, gallery: torch.Tensor, b: int, tr) -> CascadeResult:
        # both budgets clamp to the candidate count
        g_slots = min(pose_capacity or max(1, b * 2), b * kp)
        f_slots = min(cascade_cfg.face_capacity or max(1, b * 2), b * kf)
        nms_k = min(cascade_cfg.pre_nms_top_k, det.pre_nms_top_k)
        with tr.span("cascade.upload"):
            images = images.to(dev)
            gallery = gallery.to(dev, torch.float32)
            if images.dtype == torch.uint8:
                images = _unit_norm(images, model.dtype)
            x_det = images.to(model.dtype)

        # ---- stage 1: detection -------------------------------------------
        with tr.span("cascade.detect"):
            if rtdetr:
                person_det, anchor_idx, query_idx = detect_rtdetr(x_det, tr)
            else:
                person_det = detect(model.person_yolo, x_det, kp, nms_k, tr,
                                    "cascade.person_yolo")
            face_det = detect(model.face_yolo, x_det, kf, nms_k, tr, "cascade.face_yolo")

        # ---- stage 2: top-F face crops -> IR-Net -> gallery match ---------
        neg_inf = torch.tensor(float("-inf"), device=dev)
        with tr.span("cascade.face"):
            face_score = torch.where(face_det.valid, face_det.scores, neg_inf).reshape(b * kf)
            fs_scores, fs_idx = topk_stable(face_score, f_slots)
            fs_valid = torch.isfinite(fs_scores)
            fs_boxes = face_det.boxes.reshape(b * kf, 4)[fs_idx]
            crops = crop_and_resize_batch(images, fs_boxes, fs_idx // kf, (112, 112))
            crops = ((crops - 0.5) / 0.5).flip(-1)  # AdaFace BGR convention
            with tr.span("cascade.irnet"):
                emb, _ = model.irnet(crops)
            sims = emb.float() @ gallery.T  # (F, N_ids)
            slot_sim = torch.where(fs_valid, sims.max(-1).values,
                                   torch.tensor(-1.0, device=dev))
            slot_id = sims.argmax(-1).to(torch.int32)
            # scatter back to the (B, Kf) grid; top-k indices are unique
            best_sim = torch.full((b * kf,), -1.0, device=dev).index_put_((fs_idx,), slot_sim)
            best_id = torch.zeros(b * kf, dtype=torch.int32,
                                  device=dev).index_put_((fs_idx,), slot_id)
            best_sim, best_id = best_sim.reshape(b, kf), best_id.reshape(b, kf)
            matched = (best_sim > cascade_cfg.match_threshold) & face_det.valid
            face_identity = torch.where(matched, best_id, torch.full_like(best_id, -1))
            face_budget_saturated = face_det.valid.sum() > f_slots

        with tr.span("cascade.pose"):
            # ---- stage 3: gate persons by contained matched faces ---------
            if cascade_cfg.gate_pose:
                gated = _face_person_gate(person_det, face_det, matched)
            else:
                gated = person_det.valid

            # ---- stage 4: top-G person crops -> ViTPose -> heatmap decode -
            gate_score = torch.where(gated, person_det.scores, neg_inf).reshape(-1)
            top_scores, top_idx = topk_stable(gate_score, g_slots)
            slot_valid = torch.isfinite(top_scores)
            slot_img = top_idx // kp
            slot_boxes = person_det.boxes.reshape(b * kp, 4)[top_idx]
            pose_crops = crop_and_resize_batch(images, slot_boxes, slot_img, pose_cfg.input_size)
            # the normalisation promotes to fp32; the model casts back to its dtype
            pose_crops = (pose_crops - mean) / std
            with tr.span("cascade.vitpose"):
                heatmaps = model.vitpose(pose_crops)
                if cascade_cfg.pose_flip_test:
                    hm_flip = model.vitpose(torch.flip(pose_crops, dims=[2]))
            if cascade_cfg.pose_flip_test:
                heatmaps = (heatmaps + flip_heatmaps(hm_flip)) * 0.5
            coords, kscores = decode_heatmaps(heatmaps.float(), boxes=slot_boxes)

            bw = slot_boxes[:, 2] - slot_boxes[:, 0]
            bh = slot_boxes[:, 3] - slot_boxes[:, 1]
            img_x = coords[..., 0] * bw[:, None] + slot_boxes[:, 0:1]
            img_y = coords[..., 1] * bh[:, None] + slot_boxes[:, 1:2]
            pose_keypoints = torch.stack([img_x, img_y], -1)
            pose_scores = kscores * slot_valid[:, None]
        # the gating funnel (``utils/profiling.py``): masks kept, summed when read
        tr.keep(persons=person_det.valid, faces=face_det.valid, face_slots=f_slots,
                face_slots_used=fs_valid, matched_faces=matched, gated_persons=gated,
                pose_slots=g_slots, pose_slots_used=slot_valid,
                face_budget_saturated=face_budget_saturated)
        result = CascadeResult(
            persons=person_det,
            faces=face_det,
            face_identity=face_identity,
            face_similarity=best_sim,
            person_gated=gated,
            face_budget_saturated=face_budget_saturated,
            pose_image_idx=torch.where(slot_valid, slot_img, torch.full_like(slot_img, -1)),
            pose_boxes=slot_boxes,
            pose_keypoints=pose_keypoints,
            pose_scores=pose_scores,
            pose_valid=slot_valid,
        )
        return RTDETRCascadeResult(*result, anchor_idx, query_idx) if rtdetr else result

    return run
