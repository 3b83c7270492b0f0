"""YOLO-txt detection dataset (WIDER FACE / COCO-person converted layouts;
``prpe_tpu/data/detection.py``, an own copy: the same files and seed give
the same samples bit for bit).

Re-derivation of the reference's detection data layer
(reference: training/lightning/object_detection/datamodule.py:38-312):
  * directory layout ``{root}/images/{split}/*.jpg`` + ``{root}/labels/{split}/*.txt``
    with one ``cls cx cy w h`` (normalized) row per box
  * box sanitation: clip centers/sizes into [0.001, 0.999], drop boxes with
    w/h < 0.01 (reference: datamodule.py:126-150)
  * resize to ``image_size`` square, /255 normalization
    (reference: datamodule.py:93-100)
  * train-time horizontal flip
  * fixed-shape output: boxes padded to ``max_gt`` with a validity mask — the
    replacement for the reference's variable-length concat collate
    (datamodule.py:195-226)

``YoloMosaicDataset`` is the standalone YOLO trainer's train-time view
(mosaic, affine, MixUp, the visual transforms, HSV, flip;
``data/augment.py``). Samples are numpy only (``native`` resizes, warps and
jitters), so forked decode workers run no torch.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Tuple

import numpy as np

from prpe_tpu_torch import native
from prpe_tpu_torch.data.image import load_image


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def sanitize_boxes(boxes: np.ndarray) -> np.ndarray:
    """Clip normalized cxcywh boxes to the valid region and drop degenerates
    (reference: object_detection/datamodule.py:126-150)."""
    if boxes.size == 0:
        return boxes.reshape(0, 5)
    out = boxes.copy()
    out[:, 3:5] = np.clip(out[:, 3:5], 0.001, 0.999)
    half = out[:, 3:5] / 2
    out[:, 1:3] = np.clip(out[:, 1:3], half + 0.001, 1 - half - 0.001)
    keep = (out[:, 3] >= 0.01) & (out[:, 4] >= 0.01)
    return out[keep]


class YoloTxtDataset:
    def __init__(
        self,
        root: str,
        split: str = "train",
        image_size: int = 640,
        max_gt: int = 64,
        augment: bool = False,
        seed: int = 0,
    ):
        self.root = pathlib.Path(root)
        self.image_dir = self.root / "images" / split
        self.label_dir = self.root / "labels" / split
        if not self.image_dir.exists():
            raise FileNotFoundError(self.image_dir)
        self.files = sorted(
            p for p in self.image_dir.iterdir() if p.suffix.lower() in IMG_EXTS
        )
        self.image_size = image_size
        self.max_gt = max_gt
        self.augment = augment
        self._rng = np.random.default_rng(seed)
        # label cache (reference keeps a per-file dict cache, datamodule.py:107)
        self._labels: Dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.files)

    def _load_labels(self, idx: int) -> np.ndarray:
        if idx in self._labels:
            return self._labels[idx]
        path = self.label_dir / (self.files[idx].stem + ".txt")
        rows: List[List[float]] = []
        if path.exists():
            for line in path.read_text().splitlines():
                parts = line.split()
                if len(parts) >= 5:
                    rows.append([float(v) for v in parts[:5]])
        arr = sanitize_boxes(np.asarray(rows, np.float32).reshape(-1, 5))
        self._labels[idx] = arr
        return arr

    def raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 HWC image, (N, 5) normalized labels) — for mosaic/mixup."""
        return load_image(self.files[idx]), self._load_labels(idx)

    def pack(self, img: np.ndarray, labels: np.ndarray) -> Dict[str, np.ndarray]:
        gt_labels = np.zeros((self.max_gt,), np.int32)
        gt_boxes = np.zeros((self.max_gt, 4), np.float32)
        gt_mask = np.zeros((self.max_gt,), bool)
        n = min(len(labels), self.max_gt)
        if n:
            gt_labels[:n] = labels[:n, 0].astype(np.int32)
            gt_boxes[:n] = labels[:n, 1:5]
            gt_mask[:n] = True
        return {"image": img, "gt_labels": gt_labels,
                "gt_boxes": gt_boxes, "gt_mask": gt_mask}

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        raw = load_image(self.files[idx])
        # raw uint8 resize; the /255 the reference applies on the host
        # (datamodule.py:93-100) happens on the device (apply_image_norm
        # "unit") so batches cross to the card at 1 byte/px
        img = native.resize_bilinear_u8(raw, self.image_size, self.image_size)
        labels = self._load_labels(idx).copy()

        if self.augment and self._rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
            if labels.size:
                labels[:, 1] = 1.0 - labels[:, 1]

        return self.pack(img, labels)


class YoloMosaicDataset:
    """Mosaic-4 + MixUp + HSV augmented view of a ``YoloTxtDataset``: the
    standalone YOLO trainer's train-time pipeline
    (reference: training/yolopt/dataset.py:59-103 ``__getitem__`` flow).

    ``set_mosaic(0.0)`` turns the mosaic off (the reference does for the
    final 10 epochs, training/yolopt/main.py:76-78). Forked decode workers
    (``data/loader.py``) reseed both this view's ``_rng`` and its
    ``base._rng``; a worker pool forks the view as it is, so a pool made
    before ``set_mosaic`` keeps the old probability.
    """

    def __init__(self, base: YoloTxtDataset, mosaic_prob: float = 1.0,
                 mixup_prob: float = 0.15, hsv: bool = True, seed: int = 0,
                 degrees: float = 0.0, translate: float = 0.1,
                 scale: float = 0.5, shear: float = 0.0,
                 visual_prob: float = 0.01):
        self.base = base
        self.mosaic_prob = mosaic_prob
        self.mixup_prob = mixup_prob
        self.hsv = hsv
        self.affine = dict(degrees=degrees, translate=translate, scale=scale, shear=shear)
        self.visual_prob = visual_prob
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.base)

    def set_mosaic(self, prob: float):
        self.mosaic_prob = prob

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from prpe_tpu_torch.data.augment import (
            hsv_augment, mixup, mosaic4, random_perspective, random_visual,
        )

        rng = self._rng
        size = self.base.image_size
        raw = self.base.raw

        if rng.random() < self.mosaic_prob:
            idxs = [idx] + list(rng.integers(0, len(self.base), 3))
            img, labels = mosaic4([raw(i) for i in idxs], size, rng)
            # the affine follows the mosaic, as in the reference's
            # load_mosaic (training/yolopt/dataset.py:174-176)
            img, labels = random_perspective(img, labels, rng, **self.affine)
            if rng.random() < self.mixup_prob:
                idxs2 = list(rng.integers(0, len(self.base), 4))
                img2, labels2 = mosaic4([raw(i) for i in idxs2], size, rng)
                img2, labels2 = random_perspective(img2, labels2, rng, **self.affine)
                img, labels = mixup(img, labels, img2, labels2, rng)
        else:
            # without the mosaic the affine still follows the resize
            # (reference: dataset.py:44-55)
            img, labels = raw(idx)
            img = native.resize_bilinear_u8(img, size, size)
            img, labels = random_perspective(img, labels, rng, **self.affine)
        # once on the final image, in the reference's order: visuals, HSV,
        # flip (dataset.py:63-78)
        if self.visual_prob > 0:
            img = random_visual(img, rng, self.visual_prob)
        if self.hsv:
            img = hsv_augment(img, rng)
        if rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
            if labels.size:
                labels = labels.copy()
                labels[:, 1] = 1.0 - labels[:, 1]
        labels = sanitize_boxes(labels.reshape(-1, 5))
        # raw uint8 out; the /255 happens on the device (apply_image_norm "unit")
        return self.base.pack(img, labels)
