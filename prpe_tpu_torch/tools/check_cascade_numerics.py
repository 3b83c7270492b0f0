"""The whole cascade in bf16 against the same cascade in fp32, on trained
weights, over synthetic scenes.

    python -m prpe_tpu_torch.tools.check_cascade_numerics bf16 [--scenes 100]
        [--person-ckpt NPZ] [--face-ckpt NPZ] [--pose-ckpt PT] [--pose-crops 128]
        [--out runs/torch_numerics/cascade_fp32_vs_bf16.json] [--device cpu]

The port's counterpart of the ``bf16`` subcommand of
``tools/check_cascade_numerics.py`` (``check_bf16``, ``:157-523``). Two
``CascadeModel``s, fp32 and bf16, share every weight: the detector
checkpoints (an ``.npz`` of a JAX YOLO variable tree, read by
``models/porting.py::variables_from_npz``), the ViTPose state dict of
``tools/make_numerics_pose_ckpt.py``, and IR-50 from seed 0 (no slot given
is random from seed 0, as the JAX tool leaves it at its init). Scenes are
``tools/scenes.py::make_skeleton_scene`` in batches of 4 from
``default_rng(7)``, through ``CascadeConfig(max_persons=8, max_faces=8,
conf_threshold=0.005, match_threshold=0.1)`` against a gallery of 16
identities, enrolled as ``cli/infer.py`` enrolls face images: the fp32
cascade's four best face boxes in each of four scenes from
``default_rng(2)``, cropped to 112^2. (The JAX tool's 16 random unit
vectors open no gate here: the best cosine of the port's random IR-50
embeddings against them stays under the 0.1 threshold, so no person would
be gated and the in-cascade pose comparison would be empty.) Detections are
matched across the dtypes by IoU (slot order is not comparable: near-tied
scores reorder the top-k), then gate and identity
flips, box and similarity drift and keypoint drift are counted. The
same-crop leg re-crops up to ``--pose-crops`` fp32 person boxes once and
runs each identical crop through both dtypes' ViTPose, once under each
attention mode of ``SAME_CROP_MODES`` (K2, K3 and K4 on the card); its keys
carry the mode as a suffix, and the unsuffixed ones, which the verdict
reads, are the default mode's (``pallas_packed``). The report has the JAX
report's keys (and its ``pass`` rule, non-vacuity included), the per-mode
keys and ``weights``; it goes to ``--out`` and is printed.

The JAX tool's ``twins`` subcommand (``:40-118``) is not ported: it holds
the JAX package against torch transcriptions, which is what the port's
``tests/test_torch_*`` do. CUDA unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import sys

import numpy as np
import torch

from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
from prpe_tpu_torch.cli.infer import embed_gallery
from prpe_tpu_torch.core.device import resolve_device
from prpe_tpu_torch.infer.cascade import (
    IMAGENET_MEAN, IMAGENET_STD, CascadeModel, build_cascade_runner,
)
from prpe_tpu_torch.models.porting import from_jax_variables, variables_from_npz
from prpe_tpu_torch.ops.heatmap import decode_heatmaps
from prpe_tpu_torch.ops.roi import crop_and_resize_batch
from prpe_tpu_torch.tools.scenes import make_skeleton_scene

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "runs" / "torch_numerics" / "cascade_fp32_vs_bf16.json"
DETECTOR_NPZ = ROOT / "runs" / "torch_numerics" / "detector_ckpt.npz"
# the same-crop leg's attention modes: K2, K3 (the (B, H, T, D) kernel), K4
SAME_CROP_MODES = ("pallas_packed", "pallas", "pallas_lnfused")
DEFAULT_MODE = "pallas_packed"


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two (N, 4) / (M, 4) xyxy box sets."""
    ax1, ay1, ax2, ay2 = a[:, None, 0], a[:, None, 1], a[:, None, 2], a[:, None, 3]
    bx1, by1, bx2, by2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], b[None, :, 3]
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    area_a = np.clip(ax2 - ax1, 0, None) * np.clip(ay2 - ay1, 0, None)
    area_b = np.clip(bx2 - bx1, 0, None) * np.clip(by2 - by1, 0, None)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def _greedy_match(boxes_a, boxes_b, thr: float = 0.6):
    """Greedy best-IoU matching -> list of (i, j, iou): each ``a`` box, in
    order of its best IoU, takes its best free ``b`` box at IoU >= ``thr``."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return []
    iou = _iou_matrix(boxes_a, boxes_b)
    pairs = []
    used_b = set()
    for i in np.argsort(-iou.max(axis=1)):
        for j in np.argsort(-iou[i]):
            if iou[i, j] < thr:
                break
            if j not in used_b:
                pairs.append((int(i), int(j), float(iou[i, j])))
                used_b.add(int(j))
                break
    return pairs


@contextlib.contextmanager
def _attn_mode(mode: str):
    saved = {k: os.environ.pop(k, None) for k in ("PRPE_ATTN_MODE", "PRPE_FUSED_ATTENTION")}
    os.environ["PRPE_ATTN_MODE"] = mode
    try:
        yield
    finally:
        os.environ.pop("PRPE_ATTN_MODE", None)
        os.environ.update({k: v for k, v in saved.items() if v is not None})


def _host(res):
    """A ``CascadeResult`` as numpy arrays (fp32 where it was bf16)."""
    def np_(t):
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return type(res)(*(type(f)(*map(np_, f)) if isinstance(f, tuple) else np_(f) for f in res))


def _enrolled_gallery(model: CascadeModel, runner, scene_size: int, dev,
                      scenes: int = 4, per_scene: int = 4) -> torch.Tensor:
    """``scenes`` x ``per_scene`` identities: the best face boxes of the
    fp32 cascade (its face slots, sorted by score) in scenes of
    ``default_rng(2)``, cropped to 112^2 uint8 and embedded by
    ``cli/infer.py::embed_gallery``."""
    rng = np.random.default_rng(2)
    imgs = np.stack([make_skeleton_scene(rng, scene_size) for _ in range(scenes)])
    x = torch.from_numpy(imgs.astype(np.float32) / 255.0).to(dev)
    faces = runner(x, torch.zeros(1, 512)).faces
    boxes = faces.boxes[:, :per_scene].reshape(-1, 4).float()
    idx = torch.arange(scenes, device=dev).repeat_interleave(per_scene)
    crops = crop_and_resize_batch(x, boxes, idx, (112, 112))
    return embed_gallery(model, (crops * 255.0).round().clamp(0, 255).byte().cpu().numpy())


def check_bf16(n_scenes: int = 100, batch: int = 4, person_ckpt=None, face_ckpt=None,
               pose_ckpt=None, pose_crops: int = 128, *, out=DEFAULT_OUT, device=None,
               scene_size: int = 640, pose_cfg: PoseConfig = PoseConfig(),
               irnet_layers: int = 50, low_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The report (and its file at ``out``, unless None). ``scene_size``,
    ``pose_cfg``, ``irnet_layers`` and ``low_dtype`` (the dtype held against
    fp32) shrink or vary the check for a run on the CPU."""
    dev = resolve_device(device)
    ccfg = CascadeConfig(max_persons=8, max_faces=8, conf_threshold=0.005, match_threshold=0.1)
    weights = {"person_yolo": person_ckpt, "face_yolo": face_ckpt, "vitpose": pose_ckpt}
    models, runners = {}, {}
    for name, dtype in (("fp32", torch.float32), ("bf16", low_dtype)):
        model = CascadeModel(DetectionConfig(), pose_cfg, irnet_layers, dtype, device=dev, seed=0)
        for slot, path in weights.items():
            if not path:
                continue
            if slot == "vitpose":
                sd = torch.load(path, map_location="cpu", weights_only=True)
            else:
                sd = from_jax_variables(variables_from_npz(path))
            getattr(model, slot).load_state_dict(sd, strict=True)
        models[name] = model
        runners[name] = build_cascade_runner(model, ccfg, pose_capacity=batch, device=dev)

    gallery = _enrolled_gallery(models["fp32"], runners["fp32"], scene_size, dev)

    rng = np.random.default_rng(7)
    # a decision is marginal when the fp32 gate score sits within eps of the
    # threshold: flips there are coin tosses in any format, counted apart
    eps = 0.02
    thr = ccfg.match_threshold
    # the confident subset (fp32 score >= conf_cut) is what a serving
    # deployment (conf 0.25) would emit; the criteria judge it
    conf_cut = 0.10
    person_total = person_matched = person_conf_total = person_conf_matched = 0
    face_total = face_matched = face_clear = 0
    face_conf_total = face_conf_matched = 0
    gate_pairs = gate_flips = gate_pairs_clear = gate_flips_clear = 0
    id_flips = 0
    pose_pairs = pose_pairs_tight = 0
    box_drift, sim_drift, kp_drift, kp_drift_tight = [0.0], [0.0], [0.0], [0.0]
    non_tight = []  # (box drift px, |score gap|, iou) of pairs >= 1 px apart
    crop_bank = []  # (image, fp32 person box) for the same-crop leg
    for _ in range(0, n_scenes, batch):
        imgs = np.stack([make_skeleton_scene(rng, scene_size).astype(np.float32) / 255.0
                         for _ in range(batch)])
        res = {name: _host(run(torch.from_numpy(imgs).to(dev, models[name].dtype), gallery))
               for name, run in runners.items()}
        a, b = res["fp32"], res["bf16"]

        for img in range(batch):
            ia = np.where(a.persons.valid[img])[0]
            ib = np.where(b.persons.valid[img])[0]
            person_total += len(ia)
            if len(crop_bank) < pose_crops:  # up to 2 fp32 person crops an image
                for s in ia[:2]:
                    crop_bank.append((imgs[img], a.persons.boxes[img, int(s)]))
            pairs = _greedy_match(a.persons.boxes[img][ia], b.persons.boxes[img][ib])
            person_matched += len(pairs)
            conf_mask = a.persons.scores[img][ia] >= conf_cut
            person_conf_total += int(conf_mask.sum())
            person_conf_matched += sum(1 for pi, _, _ in pairs if conf_mask[pi])
            img_marginal = bool((a.faces.valid[img]
                                 & (np.abs(a.face_similarity[img] - thr) <= eps)).any())
            for pi, pj, pair_iou in pairs:
                sa, sb = int(ia[pi]), int(ib[pj])
                bd = float(np.abs(a.persons.boxes[img, sa] - b.persons.boxes[img, sb]).max())
                box_drift.append(bd)
                if bd >= 1.0:
                    non_tight.append((bd, float(abs(a.persons.scores[img, sa]
                                                    - b.persons.scores[img, sb])),
                                      float(pair_iou)))
                gate_pairs += 1
                flip = bool(a.person_gated[img, sa] != b.person_gated[img, sb])
                gate_flips += int(flip)
                if not img_marginal:
                    gate_pairs_clear += 1
                    gate_flips_clear += int(flip)

            fa = np.where(a.faces.valid[img])[0]
            fb = np.where(b.faces.valid[img])[0]
            face_total += len(fa)
            fpairs = _greedy_match(a.faces.boxes[img][fa], b.faces.boxes[img][fb])
            face_matched += len(fpairs)
            fconf = a.faces.scores[img][fa] >= conf_cut
            face_conf_total += int(fconf.sum())
            face_conf_matched += sum(1 for pi, _, _ in fpairs if fconf[pi])
            for pi, pj, _ in fpairs:
                sa, sb = int(fa[pi]), int(fb[pj])
                sim_drift.append(float(np.abs(a.face_similarity[img, sa]
                                              - b.face_similarity[img, sb])))
                if abs(float(a.face_similarity[img, sa]) - thr) > eps:
                    face_clear += 1
                    id_flips += int(a.face_identity[img, sa] != b.face_identity[img, sb])

        # pose slots: matched by (image, person-box IoU)
        for sa in np.where(a.pose_valid)[0]:
            img = int(a.pose_image_idx[sa])
            cand = [sb for sb in np.where(b.pose_valid)[0] if int(b.pose_image_idx[sb]) == img]
            if not cand:
                continue
            ious = _iou_matrix(a.pose_boxes[sa][None],
                               np.stack([b.pose_boxes[c] for c in cand]))[0]
            j = int(np.argmax(ious))
            if ious[j] < 0.6:
                continue
            sb = cand[j]
            pose_pairs += 1
            d = float(np.abs(a.pose_keypoints[sa] - b.pose_keypoints[sb]).max())
            kp_drift.append(d)
            if float(np.abs(a.pose_boxes[sa] - b.pose_boxes[sb]).max()) < 1.0:
                pose_pairs_tight += 1  # the same crop to within a pixel
                kp_drift_tight.append(d)

    same_crop = {mode: _same_crop_drift(models, crop_bank, pose_cfg, dev, mode)
                 for mode in SAME_CROP_MODES}
    same_crop_drift = same_crop[DEFAULT_MODE]

    report = {
        "scenes": n_scenes,
        "person_detections_fp32": person_total,
        "person_detection_match_rate": round(person_matched / max(person_total, 1), 4),
        "confident_score_cut": conf_cut,
        "person_confident_fp32": person_conf_total,
        "person_confident_match_rate": round(person_conf_matched / max(person_conf_total, 1), 4),
        "face_confident_fp32": face_conf_total,
        "face_confident_match_rate": round(face_conf_matched / max(face_conf_total, 1), 4),
        "matched_person_box_drift_maxabs_px": float(max(box_drift)),
        "gate_pairs": gate_pairs,
        "gate_flips": gate_flips,
        "gate_pairs_clear_margin": gate_pairs_clear,
        "gate_flips_clear_margin": gate_flips_clear,
        "face_detections_fp32": face_total,
        "face_detection_match_rate": round(face_matched / max(face_total, 1), 4),
        "face_similarity_drift_maxabs": float(max(sim_drift)),
        "face_pairs_clear_margin": face_clear,
        "identity_flips_clear_margin": id_flips,
        "margin_eps": eps,
        # pose keypoints are pixels of the scene
        "pose_pairs": pose_pairs,
        "keypoint_drift_maxabs_px640": float(max(kp_drift)),
        "pose_pairs_tight": pose_pairs_tight,
        "keypoint_drift_tight_maxabs_px640": float(max(kp_drift_tight)),
        **_same_crop_keys(same_crop_drift, ""),
        "non_tight_pairs": len(non_tight),
        "non_tight_box_drift_max_px": float(max((t[0] for t in non_tight), default=0.0)),
        "non_tight_score_gap_max": float(max((t[1] for t in non_tight), default=0.0)),
        "non_tight_iou_min": float(min((t[2] for t in non_tight), default=1.0)),
    }
    for mode, drift in same_crop.items():
        report.update(_same_crop_keys(drift, f"_{mode}"))
    # the JAX tool's criteria: at most 0.5 % of clear-margin gate and
    # identity decisions flip, same-crop keypoints within 0.5 % of the image
    # side (3.2 px at 640) over at least 50 crops, and 95 % of confident
    # fp32 detections matched; a comparison of nothing does not pass
    report["criteria"] = {
        "clear_gate_flip_rate_max": 0.005,
        "identity_flip_rate_max": 0.005,
        "same_crop_keypoint_drift_px640_max": 3.2,
        "same_crop_pairs_min": 50,
        "detection_match_rate_min": 0.95,
        "judged_on": "confident subset (fp32 score >= confident_score_cut)",
        "non_vacuous": "person/face/pose comparisons must be non-empty",
    }
    report["pass"] = bool(
        person_total > 0 and face_clear > 0 and pose_pairs > 0
        and person_conf_total > 0 and face_conf_total > 0
        and report["pose_same_crop_pairs"] >= 50
        and report["person_confident_match_rate"] >= 0.95
        and report["face_confident_match_rate"] >= 0.95
        and gate_flips_clear <= 0.005 * max(gate_pairs_clear, 1)
        and id_flips <= 0.005 * max(face_clear, 1)
        and report["keypoint_drift_same_crop_maxabs_px640"] <= 3.2
    )
    # one detector checkpoint serves both detector slots where both name it
    report["weights"] = {slot: (str(path) if path else "random, seed 0")
                         for slot, path in weights.items()}
    report["weights"]["irnet"] = "random, seed 0"
    report["weights"]["gallery"] = "16 faces enrolled from scenes of default_rng(2)"
    if out is not None:
        out = pathlib.Path(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


def _same_crop_keys(drift, suffix: str) -> dict:
    return {f"pose_same_crop_pairs{suffix}": len(drift) - 1,
            f"keypoint_drift_same_crop_maxabs_px640{suffix}": float(max(drift)),
            f"keypoint_drift_same_crop_p99_px640{suffix}": (
                float(np.percentile(drift, 99)) if len(drift) > 1 else 0.0)}


def _same_crop_drift(models, crop_bank, pose_cfg: PoseConfig, dev, mode: str) -> list:
    """[0.0] + per banked crop, the largest keypoint drift in scene pixels
    between the fp32 and the low-precision ViTPose on the identical fp32
    crop, under attention ``mode``."""
    drift = [0.0]
    if not crop_bank:
        return drift
    cb = 16  # crop batch; the bank is padded to a multiple with its last entry
    bank = crop_bank + [crop_bank[-1]] * (-len(crop_bank) % cb)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    with _attn_mode(mode), torch.inference_mode():
        for s in range(0, len(bank), cb):
            chunk = bank[s:s + cb]
            images = torch.from_numpy(np.stack([c[0] for c in chunk])).to(dev)
            boxes = torch.from_numpy(np.stack([c[1] for c in chunk])).to(dev)
            crops = crop_and_resize_batch(images, boxes, torch.arange(len(chunk), device=dev),
                                          pose_cfg.input_size)
            crops = (crops - mean) / std
            coords = {name: decode_heatmaps(m.vitpose(crops.to(m.dtype)).float())[0]
                      for name, m in models.items()}
            bwh = torch.stack([boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]], -1)
            # normalised-crop drift -> scene pixels through the source box
            d = (coords["fp32"] - coords["bf16"]).abs() * bwh[:, None, :]
            drift += d.reshape(len(chunk), -1).amax(-1).cpu().tolist()
    return drift[:1 + len(crop_bank)]  # without the padding's duplicates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cmd", nargs="?", default="bf16", choices=("bf16",))
    ap.add_argument("--scenes", type=int, default=100)
    ap.add_argument("--person-ckpt", default=None,
                    help="npz of a trained JAX YOLO variable tree for the person detector "
                         f"(e.g. {DETECTOR_NPZ.relative_to(ROOT)}); trained scores keep "
                         "the NMS selection stable across dtypes")
    ap.add_argument("--face-ckpt", default=None, help="the same for the face detector")
    ap.add_argument("--pose-ckpt", default=None,
                    help="tools/make_numerics_pose_ckpt.py state dict: trained heatmaps make "
                         "the keypoint comparison non-vacuous")
    ap.add_argument("--pose-crops", type=int, default=128,
                    help="same-crop leg sample size (fp32 person boxes re-cropped once, run "
                         "through both dtypes' ViTPose)")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    a = ap.parse_args(argv)
    check_bf16(a.scenes, person_ckpt=a.person_ckpt, face_ckpt=a.face_ckpt,
               pose_ckpt=a.pose_ckpt, pose_crops=a.pose_crops, out=a.out, device=a.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
