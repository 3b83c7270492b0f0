"""Keypoint heatmap decoding (``prpe_tpu/ops/heatmap.py:140-215``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# left/right channel permutation of the 17 COCO keypoints for the flip test
COCO_FLIP_PERM = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def decode_heatmaps(heatmaps: torch.Tensor, boxes: Optional[torch.Tensor] = None, *,
                    nominal_scale: float = 96.0,
                    method: str = "argmax") -> Tuple[torch.Tensor, torch.Tensor]:
    """Keypoints from raw heatmaps (B, K, H, W).

    ``argmax`` (the default): hard argmax (first maximum, as ``jnp.argmax``)
    plus a quarter-pixel shift toward the larger neighbour. ``soft``: softmax
    expectation over the whole map. Scores are the softmax maximum under both,
    optionally weighted by the sqrt box area of ``boxes`` (B, 4).

    Returns coords (B, K, 2) normalised (x, y) and scores (B, K).
    """
    b, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, k, h * w)
    prob = torch.softmax(flat, dim=-1)

    if method == "soft":
        xs = torch.arange(w, dtype=heatmaps.dtype, device=heatmaps.device)
        ys = torch.arange(h, dtype=heatmaps.dtype, device=heatmaps.device)
        probhw = prob.reshape(b, k, h, w)
        x_exp = torch.einsum("bkhw,w->bk", probhw, xs) + 0.5
        y_exp = torch.einsum("bkhw,h->bk", probhw, ys) + 0.5
    elif method == "argmax":
        idx = flat.argmax(dim=-1)
        iy = torch.div(idx, w, rounding_mode="floor").float()
        ix = (idx % w).float()

        def at(dx: int, dy: int) -> torch.Tensor:
            xx = (ix + dx).clamp(0, w - 1)
            yy = (iy + dy).clamp(0, h - 1)
            lin = (yy * w + xx).long()
            return torch.gather(flat, -1, lin[..., None])[..., 0]

        x_exp = ix + 0.5 + 0.25 * torch.sign(at(1, 0) - at(-1, 0))
        y_exp = iy + 0.5 + 0.25 * torch.sign(at(0, 1) - at(0, -1))
    else:
        raise ValueError(method)
    coords = torch.stack([x_exp / w, y_exp / h], dim=-1)

    scores = prob.max(dim=-1).values
    if boxes is not None:
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        scale_weight = (area.clamp(min=0.0).sqrt() / nominal_scale).clamp(0.5, 2.0)
        scores = scores * scale_weight[:, None]
    return coords, scores


def flip_heatmaps(heatmaps: torch.Tensor) -> torch.Tensor:
    """Flip-test transform: mirror W and swap the left/right channels."""
    perm = torch.tensor(COCO_FLIP_PERM, device=heatmaps.device)
    return torch.flip(heatmaps, dims=[-1])[:, perm]
