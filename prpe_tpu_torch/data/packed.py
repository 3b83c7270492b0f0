"""On-device normalisation of raw pixels (``prpe_tpu/data/packed.py:58-76``).

Packed batches ship uint8 pixels; each task's step re-applies the
normalisation its dataset would have applied on the host. The packed
dataset format itself comes with the data pipeline.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def apply_image_norm(img: torch.Tensor, norm: Optional[str]) -> torch.Tensor:
    """uint8 pixels -> the task's normalisation in fp32 (``unit`` x/255,
    ``half`` x/127.5 - 1, ``imagenet`` (x - 255 mean) / (255 std)); a float
    input passes through."""
    if img.dtype != torch.uint8:
        return img
    x = img.float()
    const = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=img.device)  # noqa: E731
    if norm is None or norm == "unit":
        return x * const(1.0 / 255.0)
    if norm == "half":
        return x * const(1.0 / 127.5) - const(1.0)
    if norm == "imagenet":
        return (x - const(_IMAGENET_MEAN * 255.0)) * const(1.0 / (_IMAGENET_STD * 255.0))
    raise ValueError(norm)
