"""Fixed-shape crop-and-resize as two interpolation contractions
(``prpe_tpu/ops/roi.py``).

Each crop is ``Wy @ image @ Wx^T`` with two-tap bilinear weight matrices.
Coordinates and weights are computed in fp32 (bf16 cannot address pixels at
640) and the weights are cast to the image dtype. ``grid_sample`` is not
used: its edge handling differs from the clipped sample centres here.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _lerp_weights(s: torch.Tensor, size: int, dtype: torch.dtype) -> torch.Tensor:
    """(K, O) fp32 sample coords in [0, size-1] -> (K, O, size) two-tap
    bilinear weight rows ``max(0, 1 - |s_o - i|)``."""
    grid = torch.arange(size, dtype=torch.float32, device=s.device)
    return (1.0 - (s[..., None] - grid).abs()).clamp(min=0.0).to(dtype)


def _sample_coords(boxes: torch.Tensor, out_hw: Tuple[int, int],
                   src_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clipped fp32 bilinear sample centres (K, oh) and (K, ow) of ``boxes``."""
    h, w = src_hw
    oh, ow = out_hw
    boxes = boxes.float()
    x1, y1, x2, y2 = boxes.unbind(-1)
    # degenerate (zero padding) boxes give zero-area crops at (0, 0)
    bw = (x2 - x1).clamp(min=1e-3)
    bh = (y2 - y1).clamp(min=1e-3)
    ys = (torch.arange(oh, dtype=torch.float32, device=boxes.device) + 0.5) / oh
    xs = (torch.arange(ow, dtype=torch.float32, device=boxes.device) + 0.5) / ow
    sy = y1[:, None] + ys[None, :] * bh[:, None] - 0.5
    sx = x1[:, None] + xs[None, :] * bw[:, None] - 0.5
    return sy.clamp(0.0, h - 1.0), sx.clamp(0.0, w - 1.0)


def crop_and_resize_batch(images: torch.Tensor, boxes: torch.Tensor,
                          box_image_idx: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinearly sample K axis-aligned crops from a batch of images.

    ``images`` (B, H, W, C), ``boxes`` (K, 4) xyxy pixels, ``box_image_idx``
    (K,) -> (K, h, w, C) crops in the image dtype.
    """
    h, w = images.shape[1:3]
    sy, sx = _sample_coords(boxes, out_hw, (h, w))
    wy = _lerp_weights(sy, h, images.dtype)  # (K, oh, H)
    wx = _lerp_weights(sx, w, images.dtype)  # (K, ow, W)
    img_k = images[box_image_idx]  # (K, H, W, C)
    rows = torch.einsum("kih,khwc->kiwc", wy, img_k)
    return torch.einsum("kjw,kiwc->kijc", wx, rows)


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
    """K crops of one image: ``image`` (H, W, C), ``boxes`` (K, 4) xyxy
    pixels -> (K, h, w, C)."""
    idx = torch.zeros(boxes.shape[0], dtype=torch.int64, device=boxes.device)
    return crop_and_resize_batch(image[None], boxes, idx, out_hw)
