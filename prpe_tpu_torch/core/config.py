"""Configuration dataclasses for the serving cascade and the combined model.

Own copies of ``prpe_tpu.core.config``'s detection, face, pose, combined
model and cascade configs, with the same field names and defaults (the
tests check each field against the JAX package). Frozen, so a config can
key a cache.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

TASKS = (
    "person_detection",
    "face_detection",
    "face_recognition",
    "pose_estimation",
)


@dataclass(frozen=True)
class DetectionConfig:
    """YOLOv11 detection branch + NMS settings."""

    num_classes: int = 1
    variant: str = "n"  # n / t / s / m / l / x
    image_size: int = 640
    adapter_size: Tuple[int, int] = (160, 160)
    conf_threshold: float = 0.001
    iou_threshold: float = 0.65
    max_det: int = 300
    # static candidate count pre-selected before NMS
    pre_nms_top_k: int = 1024
    # class-offset trick constant
    max_wh: float = 7680.0
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    assigner_top_k: int = 10
    assigner_alpha: float = 0.5
    assigner_beta: float = 6.0
    max_gt: int = 64
    reg_max: int = 16  # DFL channels


@dataclass(frozen=True)
class AdaFaceConfig:
    """Face-recognition branch."""

    arch: str = "ir_50"
    head: str = "adaface"  # adaface / arcface / cosface
    num_classes: int = 85742
    embedding_size: int = 512
    input_size: Tuple[int, int] = (112, 112)
    m: float = 0.4
    h: float = 0.333
    t_alpha: float = 0.01
    s: float = 64.0


@dataclass(frozen=True)
class PoseConfig:
    """Pose branch: ViTPose-B with the simple decoder."""

    num_keypoints: int = 17
    input_size: Tuple[int, int] = (256, 192)  # H, W fed into ViT
    heatmap_size: Tuple[int, int] = (64, 48)  # H, W
    sigma: float = 2.0
    keypoint_thresh: float = 0.3
    use_ohkm: bool = True
    ohkm_topk: int = 8
    use_oks_loss: bool = True
    oks_loss_weight: float = 0.1
    max_instances: int = 16
    vit_hidden: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    vit_mlp_ratio: int = 4
    patch_size: int = 16
    decoder_scale_factor: int = 4  # "simple" decoder: bilinear x4 + 3x3 conv


@dataclass(frozen=True)
class CombinedModelConfig:
    """The shared-trunk multi-task model: ResNet trunk, three adapters and
    four task branches."""

    backbone_channels: int = 2048
    # ResNet bottleneck counts per stage; (3, 4, 6, 3) == ResNet-50
    backbone_stages: Tuple[int, int, int, int] = (3, 4, 6, 3)
    # rematerialise the trunk's blocks on the backward pass; no effect on a
    # forward pass
    remat_backbone: bool = False
    image_size: int = 640
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    face: AdaFaceConfig = field(default_factory=AdaFaceConfig)
    pose: PoseConfig = field(default_factory=PoseConfig)


@dataclass(frozen=True)
class CascadeConfig:
    """detect -> recognize -> pose gated inference cascade."""

    # max person detections considered per image
    max_persons: int = 8
    # max face detections matched against the gallery
    max_faces: int = 8
    # cosine-similarity gate threshold for identity match
    match_threshold: float = 0.4
    # detection confidence gate for serving
    conf_threshold: float = 0.25
    # run pose only for persons whose face matched an enrolled identity
    gate_pose: bool = True
    # horizontal flip-test averaging on the pose stage (doubles its cost)
    pose_flip_test: bool = False
    # total IR-50 embedding slots across the batch (top-F faces by score);
    # None -> 2 * batch size
    face_capacity: Optional[int] = None
    # static NMS candidate count for cascade inference
    pre_nms_top_k: int = 256
