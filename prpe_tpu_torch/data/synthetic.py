"""Deterministic synthetic batches for every task schema
(``prpe_tpu/data/synthetic.py``, an own numpy copy: the same seed gives the
same batches as the JAX package's).

The trainer falls back to them when a task's dataset is not on disk.
Images hold simple structure (bright rectangles and keypoint dots on noise,
class-dependent stripes for faces), so the losses are not degenerate.
Batches are numpy dicts; the train steps move them to the model's device.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _draw_rect(img, x1, y1, x2, y2, color):
    img[y1:y2, x1:x2] = color


def detection_batch(
    rng: np.random.Generator,
    batch_size: int = 4,
    image_size: int = 128,
    max_gt: int = 8,
    num_objects: Tuple[int, int] = (1, 4),
) -> Dict[str, np.ndarray]:
    """Images with bright rectangles; gt boxes in normalized cxcywh."""
    imgs = rng.uniform(0, 0.3, size=(batch_size, image_size, image_size, 3)).astype(np.float32)
    labels = np.zeros((batch_size, max_gt), np.int32)
    boxes = np.zeros((batch_size, max_gt, 4), np.float32)
    mask = np.zeros((batch_size, max_gt), bool)
    for b in range(batch_size):
        n = int(rng.integers(num_objects[0], num_objects[1] + 1))
        for i in range(min(n, max_gt)):
            w = rng.uniform(0.15, 0.4)
            h = rng.uniform(0.15, 0.4)
            cx = rng.uniform(w / 2, 1 - w / 2)
            cy = rng.uniform(h / 2, 1 - h / 2)
            color = rng.uniform(0.7, 1.0, size=3)
            x1, y1 = int((cx - w / 2) * image_size), int((cy - h / 2) * image_size)
            x2, y2 = int((cx + w / 2) * image_size), int((cy + h / 2) * image_size)
            _draw_rect(imgs[b], x1, y1, x2, y2, color)
            boxes[b, i] = [cx, cy, w, h]
            mask[b, i] = True
    return {"image": imgs, "gt_labels": labels, "gt_boxes": boxes, "gt_mask": mask}


def face_batch(
    rng: np.random.Generator,
    batch_size: int = 8,
    image_size: int = 128,
    num_classes: int = 32,
) -> Dict[str, np.ndarray]:
    """Class-conditional striped images so identity is learnable."""
    labels = rng.integers(0, num_classes, size=(batch_size,)).astype(np.int32)
    imgs = rng.uniform(0, 0.2, size=(batch_size, image_size, image_size, 3)).astype(np.float32)
    for b, c in enumerate(labels):
        phase = 2 * np.pi * c / num_classes
        xs = np.linspace(0, 4 * np.pi, image_size)
        pattern = 0.5 + 0.5 * np.sin(xs + phase)
        imgs[b, :, :, c % 3] += pattern[None, :].astype(np.float32)
    return {"image": np.clip(imgs, 0, 1), "label": labels}


def pose_batch(
    rng: np.random.Generator,
    batch_size: int = 4,
    image_size: int = 128,
    max_instances: int = 4,
    num_keypoints: int = 17,
) -> Dict[str, np.ndarray]:
    kpts = np.zeros((batch_size, max_instances, num_keypoints, 3), np.float32)
    boxes = np.zeros((batch_size, max_instances, 4), np.float32)
    areas = np.zeros((batch_size, max_instances), np.float32)
    mask = np.zeros((batch_size, max_instances), bool)
    imgs = rng.uniform(0, 0.3, size=(batch_size, image_size, image_size, 3)).astype(np.float32)
    for b in range(batch_size):
        n = int(rng.integers(1, max_instances + 1))
        for i in range(n):
            cx, cy = rng.uniform(0.3, 0.7, size=2)
            s = rng.uniform(0.1, 0.25)
            pts = np.clip(
                np.stack([cx, cy]) + rng.normal(0, s / 2, size=(num_keypoints, 2)),
                0.02, 0.98,
            )
            vis = rng.integers(1, 3, size=(num_keypoints,))
            kpts[b, i, :, :2] = pts
            kpts[b, i, :, 2] = vis
            x1, y1 = pts.min(0) - 0.02
            x2, y2 = pts.max(0) + 0.02
            boxes[b, i] = [x1 * image_size, y1 * image_size, x2 * image_size, y2 * image_size]
            areas[b, i] = (x2 - x1) * (y2 - y1) * image_size**2
            mask[b, i] = True
            for p in pts:
                x, y = int(p[0] * image_size), int(p[1] * image_size)
                imgs[b, max(0, y - 1):y + 2, max(0, x - 1):x + 2] = 1.0
    return {"image": imgs, "keypoints": kpts, "boxes": boxes, "areas": areas, "mask": mask}


def make_loader(task: str, *, batches_per_epoch: int = 4, seed: int = 0, **kw):
    """Returns epoch -> iterator of batches, the loader protocol the
    round-robin trainer consumes."""
    makers = {
        "person_detection": detection_batch,
        "face_detection": detection_batch,
        "face_recognition": face_batch,
        "pose_estimation": pose_batch,
    }
    maker = makers[task]

    def loader(epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed * 10_000 + epoch)
        for _ in range(batches_per_epoch):
            yield maker(rng, **kw)

    loader.steps_per_epoch = batches_per_epoch
    return loader
