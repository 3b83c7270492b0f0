"""COCO-keypoints pose dataset (dependency-free: plain-json COCO parsing;
``prpe_tpu/data/pose.py``, an own copy).

Re-derivation of the reference pipeline
(reference: training/lightning/pose_estimation/datamodule.py:50-493):
  * person category only, ``num_keypoints >= min_keypoints``, non-crowd
    filtering (reference: datamodule.py:104-117)
  * full-image pipeline: letterbox to ``image_size`` square + ImageNet
    normalization (reference: datamodule.py:125-145)
  * pad-to-``max_instances`` collate producing
    {image, keypoints[N,17,3], boxes[N,4], areas[N], mask[N], is_crowd[N],
    image_id} (reference: datamodule.py:444-493)
  * keypoint coordinates normalized to [0, 1] of the letterboxed frame
  * exposes ``annotations_path`` for COCO-format evaluation
    (reference: datamodule.py:421)

pycocotools is not required: the tiny subset of COCO-json access used here is
inlined (and pycocotools is absent from this deployment).
"""

from __future__ import annotations

import json
import pathlib
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from prpe_tpu_torch import native
from prpe_tpu_torch.data.image import load_image
from prpe_tpu_torch.ops.heatmap import COCO_FLIP_PERM

NUM_KEYPOINTS = 17


class CocoKeypointDataset:
    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        annotations_path: Optional[str] = None,
        image_size: int = 640,
        max_instances: int = 16,
        min_keypoints: int = 1,
        augment: bool = False,
        seed: int = 0,
    ):
        root = pathlib.Path(data_dir)
        self.image_dir = root / "images" / split
        if annotations_path is None:
            annotations_path = str(
                root / "annotations" / f"person_keypoints_{split}2017.json"
            )
        self.annotations_path = annotations_path
        self.image_size = image_size
        self.max_instances = max_instances
        self.augment = augment
        self._rng = np.random.default_rng(seed)

        with open(annotations_path) as f:
            coco = json.load(f)
        person_cats = {
            c["id"] for c in coco.get("categories", []) if c.get("name") == "person"
        } or {1}
        anns_by_img: Dict[int, List[dict]] = defaultdict(list)
        for a in coco.get("annotations", []):
            if a.get("category_id") not in person_cats:
                continue
            if a.get("num_keypoints", 0) < min_keypoints:
                continue
            if a.get("iscrowd", 0):
                continue
            anns_by_img[a["image_id"]].append(a)

        self.images = [
            im for im in coco.get("images", []) if anns_by_img.get(im["id"])
        ]
        self.anns_by_img = anns_by_img

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.images[idx]
        img_path = self.image_dir / info["file_name"]
        img = load_image(img_path)
        h0, w0 = img.shape[:2]
        # raw uint8 letterbox (reference geometry:
        # pose_estimation/datamodule.py:125-145); the ImageNet normalize
        # happens on the device (apply_image_norm "imagenet") so batches
        # ship at 1 byte/px
        x, scale, (top, left) = native.letterbox_u8(img, self.image_size)

        n_max = self.max_instances
        kpts = np.zeros((n_max, NUM_KEYPOINTS, 3), np.float32)
        boxes = np.zeros((n_max, 4), np.float32)
        areas = np.zeros((n_max,), np.float32)
        mask = np.zeros((n_max,), bool)
        is_crowd = np.zeros((n_max,), bool)

        anns = self.anns_by_img[info["id"]][:n_max]
        size = float(self.image_size)
        for i, a in enumerate(anns):
            k = np.asarray(a["keypoints"], np.float32).reshape(-1, 3)[:NUM_KEYPOINTS]
            # map to letterboxed pixels, then normalize to [0, 1]
            kx = (k[:, 0] * scale + left) / size
            ky = (k[:, 1] * scale + top) / size
            kpts[i, :, 0] = np.clip(kx, 0, 1)
            kpts[i, :, 1] = np.clip(ky, 0, 1)
            kpts[i, :, 2] = k[:, 2]
            bx, by, bw, bh = a["bbox"]
            boxes[i] = [
                bx * scale + left, by * scale + top,
                (bx + bw) * scale + left, (by + bh) * scale + top,
            ]
            areas[i] = a.get("area", bw * bh) * scale * scale
            mask[i] = True

        flip = self.augment and self._rng.random() < 0.5
        if flip:
            x = x[:, ::-1].copy()
            kpts[:, :, 0] = np.where(kpts[:, :, 2] > 0, 1.0 - kpts[:, :, 0], 0.0)
            # left/right joint swap
            perm = np.asarray(COCO_FLIP_PERM)
            kpts = kpts[:, perm]
            x1 = size - boxes[:, 2]
            x2 = size - boxes[:, 0]
            boxes = np.stack([x1, boxes[:, 1], x2, boxes[:, 3]], -1)

        return {
            "image": x,
            "keypoints": kpts,
            "boxes": boxes.astype(np.float32),
            "areas": areas,
            "mask": mask,
            "is_crowd": is_crowd,
            "image_id": np.int64(info["id"]),
            "scale": np.float32(scale),
            "pad": np.asarray([top, left], np.float32),
        }
