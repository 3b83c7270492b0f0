"""Synthetic inputs of the numerics harness, numpy only: each function draws
from its generator in the same order as the repository's JAX-side script it
copies, so the same seed gives bit-identical arrays.

- :func:`make_scene` is ``bench_io.py:31-43`` ``_make_scene``: a uint8 scene of
  person-like rectangles with a brighter face strip on dark noise;
- :func:`make_skeleton_scene` is the closure ``_make_scene`` of
  ``tools/check_cascade_numerics.py:170-198``: the same rectangles with a
  skeleton of 17 coloured discs in each, the pose checkpoint's training
  distribution;
- :func:`make_crop_batch` is ``tools/make_numerics_pose_ckpt.py:29-72``:
  256x192 crops of one such person filling 80-100 % of the frame, with
  keypoints and box areas.

The keypoint colours and skeleton are those of ``tools/make_dataset.py``.
"""

from __future__ import annotations

import numpy as np

from prpe_tpu_torch.tools.make_dataset import KP_COLORS, SKELETON


def make_scene(rng: np.random.Generator, size: int) -> np.ndarray:
    """(size, size, 3) uint8: 1-3 person rectangles with a face strip."""
    img = (rng.random((size, size, 3)) * 60).astype(np.uint8)
    for _ in range(rng.integers(1, 4)):
        x, y = rng.integers(0, size - 200, 2)
        w, h = rng.integers(80, 200), rng.integers(160, 320)
        h = min(h, size - y - 1)
        w = min(w, size - x - 1)
        img[y:y + h, x:x + w] = rng.integers(120, 255, 3, np.uint8)
        fh = max(h // 4, 16)
        img[y:y + fh, x:x + w] = rng.integers(180, 255, 3, np.uint8)
    return img


def make_skeleton_scene(rng: np.random.Generator, size: int) -> np.ndarray:
    """(size, size, 3) uint8: :func:`make_scene`'s rectangles (120-199 wide,
    240-319 tall) each with a jittered skeleton of 17 coloured discs."""
    img = (rng.random((size, size, 3)) * 60).astype(np.uint8)
    for _ in range(rng.integers(1, 4)):
        x, y = rng.integers(0, size - 200, 2)
        w, h = int(rng.integers(120, 200)), int(rng.integers(240, 320))
        h = min(h, size - y - 1)
        w = min(w, size - x - 1)
        img[y:y + h, x:x + w] = rng.integers(120, 255, 3, np.uint8)
        fh = max(h // 4, 16)
        img[y:y + fh, x:x + w] = rng.integers(180, 255, 3, np.uint8)
        pts = SKELETON + rng.normal(0, 0.02, SKELETON.shape)
        for k in range(17):
            kx = int(np.clip(x + pts[k, 0] * w, 1, size - 2))
            ky = int(np.clip(y + pts[k, 1] * h, 1, size - 2))
            r = max(int(0.011 * size), 3)
            ys, xs = np.ogrid[-r:r + 1, -r:r + 1]
            disc = ys * ys + xs * xs <= r * r
            y1, y2 = max(ky - r, 0), min(ky + r + 1, size)
            x1, x2 = max(kx - r, 0), min(kx + r + 1, size)
            img[y1:y2, x1:x2][disc[r - (ky - y1): r + (y2 - ky),
                                   r - (kx - x1): r + (x2 - kx)]] = (
                KP_COLORS[k] * 255).astype(np.uint8)
    return img


def make_crop_batch(rng: np.random.Generator, n: int, h: int = 256, w: int = 192):
    """``n`` person crops as the cascade's pose stage sees them -> images
    (n, h, w, 3) fp32 in [0, 1], keypoints (n, 1, 17, 3) as normalised
    (x, y, visibility 2), areas (n, 1) of the drawn box in crop pixels."""
    imgs = np.empty((n, h, w, 3), np.float32)
    kps = np.zeros((n, 1, 17, 3), np.float32)
    areas = np.zeros((n, 1), np.float32)
    for i in range(n):
        img = rng.uniform(0, 0.25, (h, w, 3))
        bw = rng.uniform(0.8, 1.0) * w
        bh = rng.uniform(0.8, 1.0) * h
        x0 = rng.uniform(0, w - bw)
        y0 = rng.uniform(0, h - bh)
        color = rng.integers(120, 255, 3) / 255.0
        img[int(y0):int(y0 + bh), int(x0):int(x0 + bw)] = color
        fh = max(int(bh) // 4, 16)
        img[int(y0):int(y0 + fh), int(x0):int(x0 + bw)] = rng.integers(180, 255, 3) / 255.0
        pts = SKELETON + rng.normal(0, 0.02, SKELETON.shape)
        for k in range(17):
            # clamped into the crop: an out-of-frame centre empties the disc
            kx = float(np.clip(x0 + pts[k, 0] * bw, 1, w - 2))
            ky = float(np.clip(y0 + pts[k, 1] * bh, 1, h - 2))
            r = int(rng.integers(5, 9))
            ys, xs = np.ogrid[-r:r + 1, -r:r + 1]
            disc = ys * ys + xs * xs <= r * r
            yy, xx = int(ky), int(kx)
            y1, y2 = max(yy - r, 0), min(yy + r + 1, h)
            x1, x2 = max(xx - r, 0), min(xx + r + 1, w)
            img[y1:y2, x1:x2][disc[r - (yy - y1): r + (y2 - yy),
                                   r - (xx - x1): r + (x2 - xx)]] = KP_COLORS[k]
            kps[i, 0, k] = (kx / w, ky / h, 2)
        imgs[i] = img
        areas[i, 0] = bw * bh
    return imgs, kps, areas
