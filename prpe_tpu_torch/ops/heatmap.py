"""Keypoint heatmaps (``prpe_tpu/ops/heatmap.py``): training targets,
decoding and the flip test."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# COCO 17-keypoint OKS sigmas (the public COCO eval constants)
COCO_SIGMAS = (0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
               0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089)

# left/right channel permutation of the 17 COCO keypoints for the flip test
COCO_FLIP_PERM = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def coco_sigmas(dtype=torch.float32, device=None) -> torch.Tensor:
    """``COCO_SIGMAS`` as a (17,) tensor: rounded to fp32 first, then to
    ``dtype``, as the JAX package's fp32 table is cast."""
    return torch.tensor(COCO_SIGMAS, dtype=torch.float32, device=device).to(dtype)


def generate_target_heatmaps(keypoints: torch.Tensor, visibility: torch.Tensor,
                             areas: Optional[torch.Tensor], *, heatmap_size: Tuple[int, int],
                             sigma: float = 2.0, nominal_scale: float = 96.0,
                             threshold: float = 0.005,
                             normalize: str = "peak") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian heatmap targets of padded instances, max-combined.

    ``keypoints`` (B, N, K, 2) normalised (x, y), ``visibility`` (B, N, K)
    COCO flags (0/1/2; padding 0), ``areas`` (B, N) for the adaptive sigma
    ``sigma * clip(sqrt(area) / nominal_scale, 0.5, 2)`` or None. Each
    instance adds a separable Gaussian (peak 1) per visible keypoint.
    ``normalize="sum"`` divides each map by its sum and zeroes values under
    ``threshold`` (the reference's option); ``"peak"`` (default) leaves the
    peaks at 1.

    Returns heatmaps (B, K, H, W) and weights (B, K): 1 where an instance
    has the keypoint at visibility 2, else 0.5 where any instance with a
    visible keypoint exists, else 0.
    """
    bsz, n, k, _ = keypoints.shape
    h, w = heatmap_size
    dtype, device = keypoints.dtype, keypoints.device
    xs = torch.arange(w, dtype=dtype, device=device)
    ys = torch.arange(h, dtype=dtype, device=device)
    mu = keypoints * torch.tensor([w, h], dtype=dtype, device=device) - 0.5  # (B, N, K, 2)
    if areas is not None:
        scale = areas.clamp(min=0.0).sqrt()
        adaptive_sigma = sigma * (scale / nominal_scale).clamp(0.5, 2.0)  # (B, N)
    else:
        adaptive_sigma = torch.full((bsz, n), sigma, dtype=dtype, device=device)
    inst_valid = (visibility > 0).any(-1)  # (B, N)

    heat = torch.zeros((bsz, k, h, w), dtype=dtype, device=device)
    weights = torch.zeros((bsz, k), dtype=dtype, device=device)
    for i in range(n):
        mu_n, visn, instn = mu[:, i], visibility[:, i], inst_valid[:, i]
        inv = 1.0 / (2.0 * adaptive_sigma[:, i, None, None] ** 2)  # (B, 1, 1)
        gy = torch.exp(-((ys[None, None, :] - mu_n[..., 1:2]) ** 2) * inv)  # (B, K, H)
        gx = torch.exp(-((xs[None, None, :] - mu_n[..., 0:1]) ** 2) * inv)  # (B, K, W)
        mask = ((visn > 0) & instn[:, None]).to(dtype)  # (B, K)
        g = torch.einsum("bkh,bkw->bkhw", gy, gx) * mask[..., None, None]
        heat = torch.maximum(heat, g)
        wn = torch.where(visn == 2, 1.0, 0.5).to(dtype) * instn[:, None].to(dtype)
        weights = torch.maximum(weights, wn)

    if normalize == "sum":
        heat = heat / (heat.sum((2, 3), keepdim=True) + 1e-8)
        heat = torch.where(heat > threshold, heat, torch.zeros((), dtype=dtype, device=device))
    elif normalize != "peak":
        raise ValueError(normalize)
    return heat, weights


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
