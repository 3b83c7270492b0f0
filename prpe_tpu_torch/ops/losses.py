"""Training losses (``prpe_tpu/ops/losses.py``): YOLO detection (CIoU + DFL
+ BCE with the TAL assigner), pose (OKS-weighted heatmap MSE with online
hard keypoint mining, the OKS log loss, PCK) and the classification
losses (BCE, softmax cross-entropy, QFL, VFL, focal).

Dense masked ops with static shapes, as in the JAX package: where the
reference gathers foreground anchors, these multiply by a mask.

``group`` (the mesh's data axis) makes each normaliser that of the global
batch, as under GSPMD: each rank's loss is then its share of the global
loss, and the shares add up to it. ``None`` is one process.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from prpe_tpu_torch.ops.anchors import dfl_decode, make_anchors
from prpe_tpu_torch.ops.assigner import assign
from prpe_tpu_torch.ops.boxes import ciou, cxcywh_to_xyxy
from prpe_tpu_torch.ops.heatmap import coco_sigmas
from prpe_tpu_torch.ops.nms import topk_stable
from prpe_tpu_torch.parallel.collectives import (
    all_reduce_, group_size, vocab_parallel_cross_entropy,
)


# ------------------------------------------------------------ classification

def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, the stable form."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, class_offset: int = 0,
                          group=None) -> torch.Tensor:
    """Cross-entropy against int labels: (..., C) x (...,) -> (...,). With a
    ``group`` (the mesh's model axis) the logits are this rank's classes
    from ``class_offset`` on, and the log-sum-exp runs over every rank's."""
    if group is not None:
        return vocab_parallel_cross_entropy(logits, labels, class_offset, group)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - true_logit


def quality_focal_loss(logits, targets, beta: float = 2.0):
    """QFL: |t - sigmoid(x)|^beta * BCE."""
    return (targets - torch.sigmoid(logits)).abs() ** beta * bce_with_logits(logits, targets)


def varifocal_loss(logits, targets, alpha: float = 0.75, gamma: float = 2.0,
                   iou_weighted: bool = True):
    """VFL: BCE weighted by the target on positives and by
    alpha |p - t|^gamma on negatives."""
    p = torch.sigmoid(logits)
    pos = (targets > 0.0).to(logits.dtype)
    neg_w = alpha * (p - targets).abs() ** gamma * (1.0 - pos)
    w = (targets * pos if iou_weighted else pos) + neg_w
    return bce_with_logits(logits, targets) * w


def focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 1.5):
    """Focal loss: BCE weighted by alpha and (1 - p_t)^gamma."""
    loss = bce_with_logits(logits, targets)
    if alpha > 0:
        loss = loss * (targets * alpha + (1 - targets) * (1 - alpha))
    if gamma > 0:
        p = torch.sigmoid(logits)
        p_t = targets * p + (1 - targets) * (1 - p)
        loss = loss * (1.0 - p_t) ** gamma
    return loss


# ------------------------------------------------------------ YOLO detection

class DetectionLoss(NamedTuple):
    total: torch.Tensor
    box: torch.Tensor
    cls: torch.Tensor
    dfl: torch.Tensor


def _df_loss(pred_dist: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: ``pred_dist`` (..., 4, reg_max) logits and
    ``target`` (..., 4) continuous bin coordinates -> (...,) mean over the
    4 sides."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    reg_max = pred_dist.shape[-1]
    left = softmax_cross_entropy(pred_dist, tl)
    right = softmax_cross_entropy(pred_dist, tr.clamp(0, reg_max - 1))
    return (left * wl + right * wr).mean(-1)


def yolo_detection_loss(level_outputs: Sequence[torch.Tensor], gt_labels: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_mask: torch.Tensor, *, num_classes: int,
                        strides: Sequence[int] = (8, 16, 32), reg_max: int = 16,
                        box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5,
                        assigner_top_k: int = 10, assigner_alpha: float = 0.5,
                        assigner_beta: float = 6.0, group=None) -> DetectionLoss:
    """The YOLOv11 training loss, in fp32.

    ``level_outputs``: per-level NHWC maps (B, H_l, W_l, 4 * reg_max + nc);
    ``gt_labels`` (B, M) int, ``gt_boxes`` (B, M, 4) normalised cxcywh,
    ``gt_mask`` (B, M). Returns the gained components; ``total`` is their
    sum.
    """
    b = level_outputs[0].shape[0]
    no = 4 * reg_max + num_classes
    level_hw = [tuple(x.shape[1:3]) for x in level_outputs]
    dt = torch.float32
    device = level_outputs[0].device

    x = torch.cat([o.reshape(b, -1, no) for o in level_outputs], dim=1).to(dt)
    pred_dist, pred_scores = x[..., :4 * reg_max], x[..., 4 * reg_max:]
    anchor_points, stride_tensor = make_anchors(level_hw, strides, dtype=dt, device=device)

    # gt boxes to input pixels, xyxy; valid where padded in and non-empty
    w_in, h_in = level_hw[0][1] * strides[0], level_hw[0][0] * strides[0]
    scale = torch.tensor([w_in, h_in, w_in, h_in], dtype=dt, device=device)
    gt_xyxy = cxcywh_to_xyxy(gt_boxes.to(dt) * scale)
    gt_valid = gt_mask.bool() & (gt_xyxy.abs().sum(-1) > 0)

    pred_bboxes = dfl_decode(pred_dist, anchor_points, reg_max)  # grid units
    assigned = assign(torch.sigmoid(pred_scores.detach()), pred_bboxes.detach() * stride_tensor,
                      anchor_points * stride_tensor, gt_labels, gt_xyxy, gt_valid,
                      num_classes=num_classes, top_k=assigner_top_k, alpha=assigner_alpha,
                      beta=assigner_beta)
    target_bboxes, target_scores, fg_mask = assigned
    # the global normaliser: summed over the data ranks before the clamp
    target_scores_sum = all_reduce_(target_scores.sum(), group).clamp(min=1.0)

    loss_cls = bce_with_logits(pred_scores, target_scores).sum() / target_scores_sum

    weight = target_scores.sum(-1) * fg_mask.to(dt)  # (B, A)
    target_grid = target_bboxes / stride_tensor
    loss_box = ((1.0 - ciou(pred_bboxes, target_grid)) * weight).sum() / target_scores_sum

    # DFL target: lt / rb distances clamped into the bin range
    lt = anchor_points - target_grid[..., :2]
    rb = target_grid[..., 2:] - anchor_points
    dfl_target = torch.cat([lt, rb], dim=-1).clamp(0.0, reg_max - 1 - 0.01)
    dist = pred_dist.reshape(*pred_dist.shape[:-1], 4, reg_max)
    loss_dfl = (_df_loss(dist, dfl_target) * weight).sum() / target_scores_sum

    return DetectionLoss(total=loss_box * box_gain + loss_cls * cls_gain + loss_dfl * dfl_gain,
                         box=loss_box * box_gain, cls=loss_cls * cls_gain, dfl=loss_dfl * dfl_gain)


# ---------------------------------------------------------------------- pose

def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor, target_weight: torch.Tensor, *,
                    use_target_weight: bool = True, use_ohkm: bool = True, ohkm_topk: int = 8,
                    loss_weight: float = 1.0, group=None) -> torch.Tensor:
    """OKS-sigma-weighted heatmap MSE with online hard keypoint mining:
    ``pred`` / ``target`` (B, K, H, W), ``target_weight`` (B, K). The hard
    keypoints are the top ``ohkm_topk`` per image, ties to the lower index."""
    b, k = pred.shape[:2]
    total = b * group_size(group)
    kw = 1.0 / (coco_sigmas(pred.dtype, pred.device) + 1e-8)
    kw = kw / kw.mean()
    per_joint = ((pred - target) ** 2).reshape(b, k, -1).mean(-1)  # (B, K)
    if use_target_weight:
        per_joint = per_joint * (target_weight * kw[None, :])
    if use_ohkm:
        _, idx = topk_stable(per_joint.detach(), ohkm_topk)
        mask = torch.nn.functional.one_hot(idx, k).to(pred.dtype).sum(1)  # (B, K)
        loss = (per_joint * mask).sum() / (total * ohkm_topk)
    else:
        loss = per_joint.mean() if group is None else per_joint.sum() / (total * k)
    return loss * loss_weight


def oks_loss(pred_coords: torch.Tensor, target_coords: torch.Tensor, target_vis: torch.Tensor,
             areas: torch.Tensor, *, loss_weight: float = 1.0, group=None) -> torch.Tensor:
    """Negative-log object keypoint similarity: coords (B, K, 2) normalised,
    ``target_vis`` (B, K), ``areas`` (B,)."""
    sig = coco_sigmas(pred_coords.dtype, pred_coords.device)
    d2 = ((pred_coords - target_coords) ** 2).sum(-1)  # (B, K)
    squared_sigma = 2.0 * sig[None, :] ** 2
    oks = torch.exp(-d2 / (2.0 * areas[:, None] * squared_sigma + 1e-8))
    vis = (target_vis > 0).to(pred_coords.dtype)
    loss = -torch.log((oks * vis).clamp(min=1e-8))
    num_vis = vis.sum(1).clamp(min=1.0)
    per_image = (loss * vis).sum(1) / num_vis
    if group is not None:
        return per_image.sum() / (per_image.shape[0] * group_size(group)) * loss_weight
    return per_image.mean() * loss_weight


def pck_accuracy(pred_coords: torch.Tensor, target_coords: torch.Tensor,
                 target_vis: torch.Tensor, areas: torch.Tensor, *,
                 alpha: float = 0.2, group=None) -> torch.Tensor:
    """PCK at alpha * sqrt(area): the share of (image, keypoint) slots that
    are visible and within the threshold. Returns a scalar."""
    threshold = alpha * areas.clamp(min=0.0).sqrt()[:, None]  # (B, 1)
    dists = torch.linalg.vector_norm(pred_coords - target_coords, dim=-1)  # (B, K)
    correct = (dists < threshold) & (target_vis > 0)
    if group is not None:
        return correct.float().sum() / (correct.numel() * group_size(group))
    return correct.float().mean()
