"""Image IO and geometric transforms on the host (``prpe_tpu/data/image.py``).

Numpy HWC uint8 arrays in and out. ``load_image`` needs PIL and raises
without it, as the JAX package's does; ``resize_image`` is torch's
antialiased bilinear resize rounded back to uint8, within one grey level of
PIL's ``BILINEAR``, so a host without PIL can resize arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    from PIL import Image

    _HAVE_PIL = True
except Exception:  # pragma: no cover - PIL is optional
    _HAVE_PIL = False


def load_image(path) -> np.ndarray:
    """Load an RGB uint8 HWC image."""
    if not _HAVE_PIL:
        raise RuntimeError("PIL not available")
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def resize_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 HWC image to ``hw`` (H, W), antialiased
    when it shrinks, as PIL's ``BILINEAR``."""
    if img.shape[:2] == tuple(hw):
        return img
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def letterbox(img: np.ndarray, size: int, pad_value: int = 0
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Longest side to ``size``, then centre-pad to a square. Returns
    (image, scale, (pad_top, pad_left)) so annotations can be mapped."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_image(img, (nh, nw))
    out = np.full((size, size, img.shape[2]), pad_value, img.dtype)
    top = (size - nh) // 2
    left = (size - nw) // 2
    out[top: top + nh, left: left + nw] = resized
    return out, scale, (top, left)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
