"""Greedy-NMS keep mask: the CUDA kernel ``csrc/nms.cu`` and its plain version.

Counterpart of ``prpe_tpu/ops/pallas/nms_kernel.py::pallas_greedy_nms``.
CPU tensors take :func:`nms_keep_plain`; CUDA tensors launch the kernel or
raise. The launch is the custom op ``prpe::nms_keep`` (as in
``attention.py``), so an exported program holds the kernel as a node.
"""

from __future__ import annotations

import torch

from prpe_tpu_torch.ops.boxes import pairwise_iou
from prpe_tpu_torch.ops.kernels._build import FLOAT, INT, PTR, Library

# NMS must reproduce the plain version's fp32 IoU bit for bit: no FMA
# contraction (IEEE division is nvcc's default without --use_fast_math).
LIBRARY = Library("nms", {"prpe_nms_keep": [PTR, PTR, PTR, INT, INT, FLOAT, PTR]},
                  routes=("nms",), flags=("-fmad=false",))
# largest candidate count the kernel takes: the JAX package's MAX_PALLAS_K
# (the (K, ceil(K/32)) bit matrix is 128 KB of shared memory at 1024)
MAX_K = 1024


def greedy_scan(suppress: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy NMS over index-ordered candidates.

    ``suppress`` (B, K, K) bool (row i suppresses column j), ``valid`` (B, K)
    bool -> keep (B, K) bool. The scan stops after the last valid index, as
    the kernel does; later candidates are invalid and never kept.
    """
    b, k = valid.shape
    keep = torch.zeros(b, k, dtype=torch.bool, device=valid.device)
    suppressed = torch.zeros_like(keep)
    any_valid = valid.any(0)
    n_iter = int(any_valid.nonzero().max()) + 1 if bool(any_valid.any()) else 0
    for i in range(n_iter):
        kept = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = kept
        suppressed |= kept[:, None] & suppress[:, i]
    return keep


def nms_keep_plain(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch greedy-NMS keep mask.

    ``boxes`` (B, K, 4) fp32 xyxy, score-descending per image, class offsets
    already added; ``valid`` (B, K) -> keep (B, K) bool.
    """
    iou = pairwise_iou(boxes.float(), boxes.float())
    return greedy_scan(iou > iou_threshold, valid.bool())


@torch.library.custom_op("prpe::nms_keep", mutates_args=(), device_types="cpu")
def _nms_keep_op(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    return nms_keep_plain(boxes, valid, iou_threshold)


@_nms_keep_op.register_kernel("cuda")
def _(boxes, valid, iou_threshold):
    b, k, _ = boxes.shape
    if boxes.data_ptr() % 16:  # the kernel reads each box as one 16-byte vector
        boxes = boxes.clone()
    keep = torch.empty(b, k, dtype=torch.bool, device=boxes.device)
    LIBRARY.launch("prpe_nms_keep", LIBRARY.routes, boxes, boxes.data_ptr(), valid.data_ptr(),
                   keep.data_ptr(), b, k, float(iou_threshold))
    return keep


@_nms_keep_op.register_fake
def _(boxes, valid, iou_threshold):
    return boxes.new_empty(boxes.shape[:2], dtype=torch.bool)


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy-NMS keep mask (B, K) bool: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors. The launch is the custom op
    ``prpe::nms_keep``, whose CPU implementation is the plain version."""
    if boxes.device.type != "cpu":
        if boxes.device.type != "cuda" or valid.device != boxes.device:
            raise ValueError(f"nms_keep: boxes on {boxes.device}, valid on {valid.device}")
        if boxes.dim() != 3 or boxes.shape[-1] != 4 or valid.shape != boxes.shape[:2]:
            raise ValueError(f"nms_keep: boxes {tuple(boxes.shape)}, valid {tuple(valid.shape)}")
        b, k, _ = boxes.shape
        if not 0 < k <= MAX_K:
            raise ValueError(f"nms_keep: K = {k} outside (0, {MAX_K}]")
        if b == 0:
            return torch.zeros(0, k, dtype=torch.bool, device=boxes.device)
        boxes = boxes.to(torch.float32).contiguous()
        valid = valid.to(torch.bool).contiguous()
    return _nms_keep_op(boxes, valid, float(iou_threshold))
