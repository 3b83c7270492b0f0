"""Task-aligned assigner (TAL) for anchor-free YOLO training
(``prpe_tpu/ops/assigner.py``).

Dense masked math with static shapes, as in the JAX package: ground truths
are padded per image to a static ``M`` and masked by ``gt_mask``; the top-k
over anchors breaks ties by the lower index (``lax.top_k``'s order, through
``ops/nms.py::topk_stable``) and every argmax takes the first maximum. The
loss calls it without gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from prpe_tpu_torch.ops.boxes import ciou
from prpe_tpu_torch.ops.nms import topk_stable


class AssignResult(NamedTuple):
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy, absolute units
    target_scores: torch.Tensor  # (B, A, nc) alignment-weighted one-hot
    fg_mask: torch.Tensor  # (B, A) bool


@torch.no_grad()
def assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor, anchor_points: torch.Tensor,
           gt_labels: torch.Tensor, gt_bboxes: torch.Tensor, gt_mask: torch.Tensor, *,
           num_classes: int, top_k: int = 10, alpha: float = 0.5, beta: float = 6.0,
           eps: float = 1e-9) -> AssignResult:
    """Assign padded ground truths to anchors.

    ``pd_scores`` (B, A, nc) post-sigmoid class scores, ``pd_bboxes``
    (B, A, 4) decoded xyxy boxes, ``anchor_points`` (A, 2), ``gt_labels``
    (B, M) int, ``gt_bboxes`` (B, M, 4) xyxy, ``gt_mask`` (B, M) bool; boxes
    and anchors in the same absolute units.
    """
    b, a, nc = pd_scores.shape
    m = gt_bboxes.shape[1]
    dt = pd_scores.dtype
    gt_mask = gt_mask.bool()

    # candidate anchors: strictly inside each valid gt box
    lt = gt_bboxes[..., None, :2]  # (B, M, 1, 2)
    rb = gt_bboxes[..., None, 2:]
    deltas = torch.cat([anchor_points[None, None] - lt, rb - anchor_points[None, None]], dim=-1)
    mask_in_gts = (deltas.amin(-1) > eps).to(dt)  # (B, M, A)
    cand_mask = mask_in_gts * gt_mask.to(dt)[..., None]

    # alignment metric: score^alpha * iou^beta
    labels = gt_labels.long().clamp(0, nc - 1)  # (B, M)
    scores_bma = torch.gather(pd_scores.transpose(1, 2), 1, labels[:, :, None].expand(b, m, a))
    bbox_scores = scores_bma * cand_mask
    overlaps = ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :]).clamp(min=0.0) * cand_mask
    align_metric = bbox_scores ** alpha * overlaps ** beta

    # top-k candidates per gt; invalid gts point every slot at anchor 0, and
    # the count > 1 rule then clears them
    _, topk_idx = topk_stable(align_metric, top_k)  # (B, M, K)
    topk_idx = torch.where(gt_mask[..., None], topk_idx, torch.zeros_like(topk_idx))
    counts = F.one_hot(topk_idx, a).to(dt).sum(-2)  # (B, M, A)
    mask_top_k = torch.where(counts > 1, torch.zeros_like(counts), counts)
    mask_pos = mask_top_k * cand_mask

    # an anchor claimed by several gts keeps the gt of largest overlap
    fg_count = mask_pos.sum(-2)  # (B, A)
    is_max_overlap = F.one_hot(overlaps.argmax(1), m).to(dt).transpose(1, 2)  # (B, M, A)
    mask_pos = torch.where((fg_count > 1)[:, None, :], is_max_overlap, mask_pos)
    fg_mask = mask_pos.sum(-2) > 0  # (B, A)
    target_gt_idx = mask_pos.argmax(-2)  # (B, A)

    target_labels = torch.gather(labels, 1, target_gt_idx)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))
    target_scores = F.one_hot(target_labels, nc).to(dt) * fg_mask[..., None].to(dt)

    # scores scaled by each gt's normalised alignment
    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(-1, keepdim=True)  # (B, M, 1)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm_align = (align_metric * pos_overlap / (pos_align + eps)).amax(-2)  # (B, A)
    target_scores = target_scores * norm_align[..., None]
    return AssignResult(target_bboxes=target_bboxes, target_scores=target_scores,
                        fg_mask=fg_mask)
