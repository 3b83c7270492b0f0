"""Host-side detection augmentations: mosaic-4, MixUp, HSV jitter, the
random-perspective affine and the low-probability visual transforms
(``prpe_tpu/data/augment.py``, an own copy: the same inputs and the same
``np.random.Generator`` state give the same arrays bit for bit, drawn in
the same order).

Re-derivations of the standalone YOLO trainer's augmentation suite
(reference: training/yolopt/dataset.py:105-176 mosaic, :382-387 mixup
beta(32,32), :274-289 HSV LUT, :324-379 random_perspective affine with
box-candidate filtering, :390-414 albumentations Blur/CLAHE/ToGray/
MedianBlur at p=0.01 each), in numpy over uint8 HWC images with
normalised cxcywh labels ``(cls, cx, cy, w, h)`` rows.

The resize, the affine warp and the HSV jitter run in the native library
(``native.py``, ``native/host_ops.cpp``), which raises when it cannot be
built: nothing here falls back to numpy on its own. ``warp_affine_plain``
is the numpy version the tests hold the library's warp against. Nothing
here runs torch, so forked decode workers call it as the parent does.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from prpe_tpu_torch import native


def hsv_augment(
    img: np.ndarray, rng: np.random.Generator,
    h_gain: float = 0.015, s_gain: float = 0.7, v_gain: float = 0.4,
) -> np.ndarray:
    """Random HSV jitter on uint8 RGB with the reference's cv2-LUT
    semantics: uint8 HSV (H in [0, 180)), per-channel gain LUTs, converted
    back (reference: training/yolopt/dataset.py:274-289)."""
    r = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    return native.hsv_lut(img, r[0], r[1], r[2])


def mosaic4(
    samples: List[Tuple[np.ndarray, np.ndarray]],
    out_size: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Combine 4 (uint8 image, (N, 5) normalised labels) into one mosaic:
    a random centre in the central half, each tile resized to fill its
    quadrant (reference: training/yolopt/dataset.py:105-176)."""
    cx = int(rng.uniform(out_size * 0.25, out_size * 0.75))
    cy = int(rng.uniform(out_size * 0.25, out_size * 0.75))
    canvas = np.full((out_size, out_size, 3), 114, np.uint8)
    quads = [
        (0, 0, cx, cy), (cx, 0, out_size, cy),
        (0, cy, cx, out_size), (cx, cy, out_size, out_size),
    ]
    all_labels = []
    for (x1, y1, x2, y2), (img, labels) in zip(quads, samples):
        qw, qh = x2 - x1, y2 - y1
        if qw <= 0 or qh <= 0:
            continue
        canvas[y1:y2, x1:x2] = native.resize_bilinear_u8(img, qh, qw)
        if labels.size:
            lab = labels.copy()
            lab[:, 1] = (lab[:, 1] * qw + x1) / out_size
            lab[:, 2] = (lab[:, 2] * qh + y1) / out_size
            lab[:, 3] = lab[:, 3] * qw / out_size
            lab[:, 4] = lab[:, 4] * qh / out_size
            all_labels.append(lab)
    labels = np.concatenate(all_labels) if all_labels else np.zeros((0, 5), np.float32)
    return canvas, labels


def _inverse(matrix: np.ndarray) -> np.ndarray:
    return np.linalg.inv(matrix).astype(np.float32)


def warp_affine(img: np.ndarray, matrix: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear affine warp of a uint8 HWC image, black border (the cv2
    ``warpAffine`` defaults the reference relies on), in the native
    library. ``matrix`` is the 3x3 forward map; sampling inverts it."""
    return native.warp_affine_u8(img, _inverse(matrix)[:2], out_h, out_w)


def warp_affine_plain(img: np.ndarray, matrix: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """The numpy version of :func:`warp_affine`: the same fp32 coordinates
    and weights, the four taps summed at once where the library blends the
    rows first, so within one grey level of it."""
    inv = _inverse(matrix)
    ys, xs = np.mgrid[0:out_h, 0:out_w].astype(np.float32)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    h, w = img.shape[:2]
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)].astype(np.float32)
        return v * ok[..., None]

    out = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def box_candidates(before_xyxy: np.ndarray, after_xyxy: np.ndarray) -> np.ndarray:
    """Keep boxes that survive an affine: sides over 2 px, over 10 % of the
    original (scale-adjusted) area, aspect ratio under 100
    (reference: training/yolopt/dataset.py:320-325 ``candidates``)."""
    w1 = before_xyxy[:, 2] - before_xyxy[:, 0]
    h1 = before_xyxy[:, 3] - before_xyxy[:, 1]
    w2 = after_xyxy[:, 2] - after_xyxy[:, 0]
    h2 = after_xyxy[:, 3] - after_xyxy[:, 1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return (w2 > 2) & (h2 > 2) & (w2 * h2 / (w1 * h1 + 1e-16) > 0.1) & (ar < 100)


def random_perspective(
    img: np.ndarray,
    labels: np.ndarray,
    rng: np.random.Generator,
    degrees: float = 0.0,
    translate: float = 0.1,
    scale: float = 0.5,
    shear: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random affine (rotate, scale, shear, translate about the image
    centre) with corner-accurate label transformation and candidate
    filtering (reference: training/yolopt/dataset.py:328-379). The
    reference works in pixel xyxy; the normalised cxcywh labels are
    converted around the same 3x3 composition
    translate @ shear @ rotate @ center."""
    h, w = img.shape[:2]

    center = np.eye(3)
    center[0, 2] = -w / 2
    center[1, 2] = -h / 2

    a = math.radians(rng.uniform(-degrees, degrees))
    s = rng.uniform(1 - scale, 1 + scale)
    rotate = np.eye(3)
    rotate[0, :2] = [s * math.cos(a), s * math.sin(a)]
    rotate[1, :2] = [-s * math.sin(a), s * math.cos(a)]

    sh = np.eye(3)
    sh[0, 1] = math.tan(math.radians(rng.uniform(-shear, shear)))
    sh[1, 0] = math.tan(math.radians(rng.uniform(-shear, shear)))

    tr = np.eye(3)
    tr[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * w
    tr[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * h

    matrix = tr @ sh @ rotate @ center
    if not np.allclose(matrix, np.eye(3)):
        img = warp_affine(img, matrix, h, w)

    if not labels.size:
        return img, labels
    # normalised cxcywh -> pixel corner points (x1y1, x2y2, x1y2, x2y1)
    cx, cy = labels[:, 1] * w, labels[:, 2] * h
    bw, bh = labels[:, 3] * w, labels[:, 4] * h
    x1, y1, x2, y2 = cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2
    n = len(labels)
    pts = np.stack([
        np.stack([x1, y1], 1), np.stack([x2, y2], 1),
        np.stack([x1, y2], 1), np.stack([x2, y1], 1),
    ], 1).reshape(n * 4, 2)
    pts = pts @ matrix[:2, :2].T + matrix[:2, 2]
    pts = pts.reshape(n, 4, 2)
    nx1, ny1 = pts[..., 0].min(1), pts[..., 1].min(1)
    nx2, ny2 = pts[..., 0].max(1), pts[..., 1].max(1)
    after = np.stack([
        np.clip(nx1, 0, w), np.clip(ny1, 0, h),
        np.clip(nx2, 0, w), np.clip(ny2, 0, h),
    ], 1)
    before = np.stack([x1 * s, y1 * s, x2 * s, y2 * s], 1)
    keep = box_candidates(before, after)
    out = labels[keep].copy()
    a4 = after[keep]
    out[:, 1] = (a4[:, 0] + a4[:, 2]) / 2 / w
    out[:, 2] = (a4[:, 1] + a4[:, 3]) / 2 / h
    out[:, 3] = (a4[:, 2] - a4[:, 0]) / w
    out[:, 4] = (a4[:, 3] - a4[:, 1]) / h
    return img, out


# --------------------------------------------------------------------------
# low-probability visual transforms (reference: dataset.py:390-414 uses
# albumentations Blur/CLAHE/ToGray/MedianBlur, each p=0.01; written out
# here; boxes are unaffected by all four)
# --------------------------------------------------------------------------

def box_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k x k mean filter through a 2-D cumulative sum with edge-clamped
    padding. The integral image accumulates in int64: fp32 sums reach ~4e8
    on a 1280^2 image, where fp32 spacing is ~32."""
    pad = k // 2
    x = img.astype(np.int64)
    x = np.pad(x, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    c = x.cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0), (0, 0)))
    h, w = img.shape[:2]
    out = (c[k:k + h, k:k + w] - c[:h, k:k + w]
           - c[k:k + h, :w] + c[:h, :w]).astype(np.float64) / (k * k)
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k x k median filter; ``np.partition`` in uint8 keeps the sliding
    window buffer at h*w*c*k^2 bytes (``np.median`` would promote it to
    float64)."""
    pad = k // 2
    x = np.pad(img, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(0, 1))
    win = win.reshape(*img.shape, k * k).copy()  # contiguous for partition
    mid = k * k // 2
    win.partition(mid, axis=-1)
    return win[..., mid]


def _luma(img: np.ndarray) -> np.ndarray:
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def to_gray(img: np.ndarray) -> np.ndarray:
    """BT.601 luma replicated to 3 channels (albumentations ToGray)."""
    g = np.clip(_luma(img.astype(np.float32)) + 0.5, 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=-1)


def clahe(img: np.ndarray, clip_limit: float = 4.0, tiles: int = 8) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation of the BT.601 luma
    with bilinear interpolation between tile mappings, applied as a
    per-pixel gain (albumentations equalises LAB-L)."""
    x = img.astype(np.float32)
    y = _luma(x)
    h, w = y.shape
    yi = np.clip(y, 0, 255).astype(np.uint8)
    th, tw = (h + tiles - 1) // tiles, (w + tiles - 1) // tiles
    clip = max(1.0, clip_limit * th * tw / 256.0)

    # per-tile clipped-histogram CDF mapping
    maps = np.zeros((tiles, tiles, 256), np.float32)
    for ti in range(tiles):
        for tj in range(tiles):
            tile = yi[ti * th:(ti + 1) * th, tj * tw:(tj + 1) * tw]
            hist = np.bincount(tile.ravel(), minlength=256).astype(np.float32)
            excess = np.maximum(hist - clip, 0).sum()
            hist = np.minimum(hist, clip) + excess / 256.0
            cdf = hist.cumsum()
            cdf = cdf / max(cdf[-1], 1.0)
            maps[ti, tj] = cdf * 255.0

    # bilinear blend of the 4 surrounding tile mappings per pixel
    gy = (np.arange(h) + 0.5) / th - 0.5
    gx = (np.arange(w) + 0.5) / tw - 0.5
    i0 = np.clip(np.floor(gy).astype(int), 0, tiles - 1)
    j0 = np.clip(np.floor(gx).astype(int), 0, tiles - 1)
    i1 = np.clip(i0 + 1, 0, tiles - 1)
    j1 = np.clip(j0 + 1, 0, tiles - 1)
    fy = np.clip(gy - i0, 0, 1)[:, None]
    fx = np.clip(gx - j0, 0, 1)[None, :]
    v = yi.astype(int)
    m00 = maps[i0[:, None], j0[None, :], v]
    m01 = maps[i0[:, None], j1[None, :], v]
    m10 = maps[i1[:, None], j0[None, :], v]
    m11 = maps[i1[:, None], j1[None, :], v]
    new_y = (m00 * (1 - fy) * (1 - fx) + m01 * (1 - fy) * fx
             + m10 * fy * (1 - fx) + m11 * fy * fx)
    gain = (new_y + 1.0) / (y + 1.0)
    return np.clip(x * gain[..., None] + 0.5, 0, 255).astype(np.uint8)


def random_visual(img: np.ndarray, rng: np.random.Generator, p: float = 0.01) -> np.ndarray:
    """Blur / CLAHE / ToGray / MedianBlur, each independently with
    probability ``p`` (reference: dataset.py:399-403, albumentations
    defaults: kernel 3..7 odd, CLAHE clip uniform(1, 4))."""
    if rng.random() < p:
        img = box_blur(img, int(rng.choice([3, 5, 7])))
    if rng.random() < p:
        img = clahe(img, float(rng.uniform(1.0, 4.0)))
    if rng.random() < p:
        img = to_gray(img)
    if rng.random() < p:
        img = median_blur(img, int(rng.choice([3, 5, 7])))
    return img


def mixup(
    img1: np.ndarray, lab1: np.ndarray,
    img2: np.ndarray, lab2: np.ndarray,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Beta(32, 32) image blend, labels concatenated
    (reference: training/yolopt/dataset.py:382-387)."""
    alpha = rng.beta(32.0, 32.0)
    img = img1.astype(np.float32) * alpha + img2.astype(np.float32) * (1 - alpha)
    return img.astype(np.uint8), np.concatenate([lab1, lab2], axis=0)
