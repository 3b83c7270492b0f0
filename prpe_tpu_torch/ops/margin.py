"""Adaptive-margin softmax heads: AdaFace, ArcFace, CosFace
(``prpe_tpu/ops/margin.py``).

Functions of explicit state, as in the JAX package: ``adaface_logits``
takes the EMA statistics of the embedding norms as a ``MarginState`` and
returns the new state beside the logits; the caller keeps it (the combined
model in its ``margin_mean`` / ``margin_std`` buffers).

Under a mesh the kernel is this rank's block of classes from
``class_offset`` on: the column normalisation is local, and the margin goes
on the label's column where that column is on this rank. The norm
statistics are those of the global batch when ``group`` (the data axis)
is given.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from prpe_tpu_torch.parallel.collectives import all_reduce_


class MarginState(NamedTuple):
    """EMA of the batch mean and std of the embedding norms."""

    batch_mean: torch.Tensor  # scalar
    batch_std: torch.Tensor  # scalar

    @staticmethod
    def init(dtype: torch.dtype = torch.float32, device=None) -> "MarginState":
        return MarginState(batch_mean=torch.tensor(20.0, dtype=dtype, device=device),
                           batch_std=torch.tensor(100.0, dtype=dtype, device=device))


def normalized_cosine(kernel: torch.Tensor, embeddings: torch.Tensor,
                      eps: Optional[float] = None) -> torch.Tensor:
    """Cosine of (B, E) embeddings against the columns of the (E, C) kernel;
    ``eps`` clips into (-1 + eps, 1 - eps) for the margin heads' arccos,
    ``None`` returns the raw cosine."""
    kernel_norm = kernel / torch.linalg.vector_norm(kernel, dim=0, keepdim=True)
    cosine = embeddings @ kernel_norm
    if eps is None:
        return cosine
    return cosine.clamp(-1.0 + eps, 1.0 - eps)


def _one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype,
             class_offset: int = 0) -> torch.Tensor:
    """(B, num_classes) one-hot of ``labels`` among the classes
    ``class_offset`` ... ``class_offset + num_classes - 1``; a row whose
    label lies outside them is zero."""
    cols = torch.arange(class_offset, class_offset + num_classes, device=labels.device)
    return (labels.long()[:, None] == cols[None, :]).to(dtype)


def norm_stats(safe_norms: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and unbiased std of the norms of the (global) batch: the mean
    first, then the squared deviations from it, each summed over
    ``group``."""
    if group is None:
        return safe_norms.mean(), safe_norms.std(correction=1)
    sums = all_reduce_(torch.stack([safe_norms.sum(), safe_norms.new_tensor(
        float(safe_norms.numel()))]), group)
    n = sums[1]
    mean = sums[0] / n
    sq = all_reduce_(((safe_norms - mean) ** 2).sum(), group)
    return mean, torch.sqrt(sq / (n - 1))


def adaface_logits(kernel: torch.Tensor, embeddings: torch.Tensor, norms: torch.Tensor,
                   labels: torch.Tensor, state: MarginState, *, m: float = 0.4,
                   h: float = 0.333, s: float = 64.0, t_alpha: float = 0.01,
                   eps: float = 1e-3, update_stats: bool = True, class_offset: int = 0,
                   group=None) -> Tuple[torch.Tensor, MarginState]:
    """AdaFace logits (B, C) and the new state.

    ``kernel`` (E, C) unnormalised prototypes (classes ``class_offset`` ...
    under a mesh), ``embeddings`` (B, E) L2-normalised, ``norms`` (B, 1)
    pre-normalisation norms, ``labels`` (B,) global class ids. With
    ``update_stats`` the EMA moves first and the margin scaler is computed
    from the moved statistics, as the JAX package does; ``group`` makes
    them the global batch's.
    """
    num_classes = kernel.shape[1]
    cosine = normalized_cosine(kernel, embeddings, eps)
    safe_norms = norms.clamp(0.001, 100.0).detach()
    if update_stats:
        mean, std = norm_stats(safe_norms, group)  # the unbiased std, as torch's default
        state = MarginState(batch_mean=mean * t_alpha + (1.0 - t_alpha) * state.batch_mean,
                            batch_std=std * t_alpha + (1.0 - t_alpha) * state.batch_std)
    margin_scaler = (safe_norms - state.batch_mean) / (state.batch_std + eps)
    margin_scaler = (margin_scaler * h).clamp(-1.0, 1.0)  # (B, 1)
    one_hot = _one_hot(labels, num_classes, cosine.dtype, class_offset)
    # angular margin, then additive margin, on the label's column only
    theta = torch.arccos(cosine)
    theta_m = (theta + one_hot * (-m * margin_scaler)).clamp(eps, math.pi - eps)
    cosine = torch.cos(theta_m) - one_hot * (m + m * margin_scaler)
    return cosine * s, state


def arcface_logits(kernel: torch.Tensor, embeddings: torch.Tensor, labels: torch.Tensor, *,
                   m: float = 0.5, s: float = 64.0, eps: float = 1e-4,
                   class_offset: int = 0) -> torch.Tensor:
    """ArcFace: s * cos(theta + m) on the label's column, s * cos(theta)
    elsewhere."""
    cosine = normalized_cosine(kernel, embeddings, eps)
    m_hot = _one_hot(labels, kernel.shape[1], cosine.dtype, class_offset) * m
    return torch.cos((torch.arccos(cosine) + m_hot).clamp(eps, math.pi - eps)) * s


def cosface_logits(kernel: torch.Tensor, embeddings: torch.Tensor, labels: torch.Tensor, *,
                   m: float = 0.4, s: float = 64.0, eps: float = 1e-4,
                   class_offset: int = 0) -> torch.Tensor:
    """CosFace: s * (cos(theta) - m) on the label's column."""
    cosine = normalized_cosine(kernel, embeddings, eps)
    return (cosine - _one_hot(labels, kernel.shape[1], cosine.dtype, class_offset) * m) * s


def init_kernel(generator: torch.Generator, embedding_size: int, num_classes: int,
                device=None) -> torch.Tensor:
    """(E, C) prototypes uniform in (-1, 1), each column scaled to unit norm.
    Draws from ``generator``, not JAX's numbers: trained weights come in
    through the bridge."""
    k = torch.rand(embedding_size, num_classes, generator=generator,
                   device=device or generator.device) * 2.0 - 1.0
    return k / torch.linalg.vector_norm(k, dim=0, keepdim=True).clamp(min=1e-12)
