"""The combined multi-task model (``prpe_tpu/models/combined.py``): one
ResNet trunk shared by four task branches.

* ``yolo_person`` / ``yolo_face``: ``YoloAdapter`` + YOLOv11 (nc = 1);
* ``ada_face``: ``AdaFaceAdapter`` + IR-Net with a 64-channel input, and the
  AdaFace prototypes ``face_kernel`` (E, C) with the margin EMA buffers
  ``margin_mean`` and ``margin_std``;
* ``vit_pose``: ``VitPoseAdapter`` + ViTPose.

Each task is its own method, as in the JAX package; ``forward(x, task)``
dispatches on the four ``TASKS``. Submodules carry the flax names, so the
weight bridge carries a JAX variable tree across. ``model.train()`` is the
JAX package's ``train=True`` for the BatchNorms (batch statistics, running
statistics moved) and IR-Net's dropout, the frozen trunk's included;
``face_logits(train=True)`` also moves the margin EMA.

Under a (data, model) mesh (``set_mesh``, which ``parallel.mesh.
shard_params`` calls) ``face_kernel`` is this rank's block of classes, every
BatchNorm reduces over the data axis, and ``face_logits`` returns this
rank's columns of the logits.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from prpe_tpu_torch.core.config import TASKS, CombinedModelConfig
from prpe_tpu_torch.core.device import resolve_device
from prpe_tpu_torch.nn.adapters import AdaFaceAdapter, VitPoseAdapter, YoloAdapter
from prpe_tpu_torch.nn.common import materialize, set_sync_group
from prpe_tpu_torch.nn.irnet import build_irnet
from prpe_tpu_torch.nn.resnet import ResNetTrunk
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.nn.yolo import YOLO
from prpe_tpu_torch.ops import margin
from prpe_tpu_torch.parallel.collectives import copy_to_group


class CombinedModel(nn.Module):
    """fp32 parameters, compute in ``dtype``; built on ``device`` (CUDA
    unless the caller names another) and filled from a ``torch.Generator``
    seeded with ``seed``. Images are NHWC (B, H, W, 3), H and W >= 64."""

    def __init__(self, config: CombinedModelConfig = CombinedModelConfig(),
                 dtype: torch.dtype = torch.float32, *, device=None, seed: int = 0):
        super().__init__()
        self.config = cfg = config
        self.dtype = dtype
        face_h, face_w = cfg.face.input_size
        if face_h != face_w:
            raise ValueError(f"face input size {cfg.face.input_size} must be square")
        dev = resolve_device(device)
        det = cfg.detection
        self.mesh = None
        self.class_offset = 0  # the first class of this rank's face_kernel
        with torch.device("meta"):
            self.backbone = ResNetTrunk(cfg.backbone_stages, cfg.remat_backbone, dtype)
            self.yolo_person_adapter = YoloAdapter(det.adapter_size)
            self.yolo_person = YOLO(nc=det.num_classes, variant=det.variant, dtype=dtype)
            self.yolo_face_adapter = YoloAdapter(det.adapter_size)
            self.yolo_face = YOLO(nc=det.num_classes, variant=det.variant, dtype=dtype)
            self.ada_face_adapter = AdaFaceAdapter(cfg.face.input_size)
            self.ada_face = build_irnet(cfg.face.arch, input_channels=64, input_size=face_h,
                                        embedding_size=cfg.face.embedding_size, dtype=dtype)
            self.face_kernel = nn.Parameter(
                torch.empty(cfg.face.embedding_size, cfg.face.num_classes))
            self.register_buffer("margin_mean", torch.empty(()))
            self.register_buffer("margin_std", torch.empty(()))
            pose = cfg.pose
            self.vit_pose_adapter = VitPoseAdapter(pose.input_size)
            self.vit_pose = ViTPose(
                image_size=pose.input_size, num_keypoints=pose.num_keypoints,
                hidden=pose.vit_hidden, layers=pose.vit_layers, heads=pose.vit_heads,
                mlp_ratio=pose.vit_mlp_ratio, patch_size=pose.patch_size,
                scale_factor=pose.decoder_scale_factor, dtype=dtype)
        materialize(self, dev, seed)

    def _init_extra(self, generator: torch.Generator) -> None:
        face = self.config.face
        self.face_kernel.copy_(margin.init_kernel(generator, face.embedding_size, face.num_classes))
        state = margin.MarginState.init(device=self.margin_mean.device)
        self.margin_mean.copy_(state.batch_mean)
        self.margin_std.copy_(state.batch_std)

    def set_mesh(self, mesh) -> None:
        """Run under ``mesh``: BatchNorm statistics over its data axis, the
        face logits over this rank's classes (``face_kernel`` already cut to
        them)."""
        self.mesh = mesh
        set_sync_group(self, mesh.data_group)
        self.class_offset = mesh.class_range(self.config.face.num_classes)[0]

    @property
    def model_group(self):
        return None if self.mesh is None else self.mesh.model_group

    @property
    def data_group(self):
        return None if self.mesh is None else self.mesh.data_group

    # ------------------------------------------------------------------ #
    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Shared trunk: (B, H, W, 3) -> (B, H/32, W/32, 2048)."""
        return self.backbone(x)

    def detect(self, x: torch.Tensor, branch: str = "person") -> List[torch.Tensor]:
        """Whole image -> the branch's raw per-level YOLO maps (NHWC)."""
        feats = self.features(x)
        if branch == "person":
            return self.yolo_person(self.yolo_person_adapter(feats))
        return self.yolo_face(self.yolo_face_adapter(feats))

    def embed_face(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whole image -> identity embedding (B, E) and pre-norm (B, 1)."""
        return self.ada_face(self.ada_face_adapter(self.features(x)))

    def face_logits(self, x: torch.Tensor, labels: torch.Tensor, train: bool = True) -> torch.Tensor:
        """AdaFace logits (B, num_classes) in fp32 (float64 in a float64
        model; this rank's classes under
        a mesh). ``train=True`` moves the margin EMA buffers first and
        computes the margin from them. The embeddings enter each class
        shard through ``copy_to_group``, so that the trunk gets the gradient
        of every shard."""
        face = self.config.face
        emb, norms = self.embed_face(x)
        acc = torch.promote_types(emb.dtype, torch.float32)
        logits, state = margin.adaface_logits(
            self.face_kernel.to(acc), copy_to_group(emb.to(acc), self.model_group),
            norms.to(acc), labels, margin.MarginState(self.margin_mean, self.margin_std),
            m=face.m, h=face.h, s=face.s, t_alpha=face.t_alpha, update_stats=train,
            class_offset=self.class_offset, group=self.data_group)
        if train:
            with torch.no_grad():
                self.margin_mean.copy_(state.batch_mean)
                self.margin_std.copy_(state.batch_std)
        return logits

    def pose(self, x: torch.Tensor) -> torch.Tensor:
        """Whole image -> keypoint heatmaps (B, K, Hh, Wh)."""
        return self.vit_pose(self.vit_pose_adapter(self.features(x)))

    def init_all(self, x: torch.Tensor, labels: torch.Tensor):
        """Every branch once: (person maps, face maps, face logits without
        an EMA update, heatmaps)."""
        return (self.detect(x, "person"), self.detect(x, "face"),
                self.face_logits(x, labels, train=False), self.pose(x))

    def forward(self, x: torch.Tensor, task: str = "pose_estimation",
                labels: Optional[torch.Tensor] = None, train: bool = False):
        if task == "person_detection":
            return self.detect(x, "person")
        if task == "face_detection":
            return self.detect(x, "face")
        if task == "face_recognition":
            if labels is not None:
                return self.face_logits(x, labels, train)
            return self.embed_face(x)
        if task == "pose_estimation":
            return self.pose(x)
        raise ValueError(f"unknown task {task!r}; supported: {TASKS}")
