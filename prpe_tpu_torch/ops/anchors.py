"""Anchor-free grid generation + DFL box decode (``prpe_tpu/ops/anchors.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def make_anchors(level_hw: Sequence[Tuple[int, int]], strides: Sequence[int],
                 offset: float = 0.5, dtype=torch.float32,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-cell centres per FPN level.

    Returns ``anchor_points`` (A, 2) in (x, y) grid units, row-major per
    level, and ``stride_tensor`` (A, 1).
    """
    pts, strs = [], []
    for (h, w), s in zip(level_hw, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + offset
        sy = torch.arange(h, dtype=dtype, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        strs.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(pts, dim=0), torch.cat(strs, dim=0)


def level_shapes(image_size: int, strides: Sequence[int] = (8, 16, 32)):
    """FPN level (H, W) of a square input of ``image_size``."""
    return [(image_size // s, image_size // s) for s in strides]


def dfl_decode(pred_dist: torch.Tensor, anchor_points: torch.Tensor,
               reg_max: int = 16) -> torch.Tensor:
    """Distribution Focal Loss decode: softmax over ``reg_max`` bins per side,
    expectation against the bin index, then lt/rb offsets from the anchor.

    ``pred_dist`` (..., A, 4 * reg_max) -> (..., A, 4) xyxy in grid units.
    """
    dist = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max)
    prob = torch.softmax(dist, dim=-1)
    proj = torch.arange(reg_max, dtype=prob.dtype, device=prob.device)
    dist = torch.einsum("...k,k->...", prob, proj)
    lt, rb = dist[..., :2], dist[..., 2:]
    return torch.cat([anchor_points - lt, anchor_points + rb], dim=-1)
