"""Configuration dataclasses for the serving cascade, the combined model,
its training and the device mesh.

Own copies of ``prpe_tpu.core.config``'s mesh, detection, face, pose,
combined model, cascade, optimizer, data, task, train and framework
configs, with the same field names and defaults (the tests check each field
against the JAX package), and its JSON round trip (``config_to_json``,
``_from_dict``). Frozen, so a config can key a cache.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

TASKS = (
    "person_detection",
    "face_detection",
    "face_recognition",
    "pose_estimation",
)


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) process mesh: ``data`` splits the global batch,
    ``model`` splits the AdaFace classifier by class."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 means "all remaining processes"
    data_parallel: int = -1
    model_parallel: int = 1


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
class OptimConfig:
    optimizer: str = "adam"  # adam / adamw / sgd
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    grad_clip_norm: float = 10.0
    # schedule: constant / linear / cosine / onecycle
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 10_000
    min_lr: float = 1e-6
    # gradient accumulation: the mean of this many gradients per update
    accumulate: int = 1
    # per-param-group lr multipliers keyed by top-level parameter name
    # (exact match), e.g. (("vit_pose", 0.1),)
    param_group_scales: Tuple[Tuple[str, float], ...] = ()
    # EMA of the parameters, with an exponential warm-up ramp
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    use_ema: bool = False


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = ""
    batch_size: int = 32
    num_workers: int = 4
    max_train_samples: Optional[int] = 2500
    max_val_samples: Optional[int] = 400
    shuffle_seed: int = 42


@dataclass(frozen=True)
class TaskConfig:
    """Per-task training config."""

    name: str = "person_detection"
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    monitor: str = "val_loss"  # metric used for best-checkpoint selection
    monitor_mode: str = "min"
    # optional W&B project, one per task
    wandb_project: Optional[str] = None
    # which parameters this task's optimizer trains: "branch" (each task
    # only its branch; the shared trunk is in no optimizer),
    # "branch+backbone" or "all"
    trainable: str = "branch"


@dataclass(frozen=True)
class TrainConfig:
    """Round-robin orchestration."""

    total_epochs: int = 15
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    save_every_epochs: int = 1
    keep_checkpoints: int = 3
    log_every_steps: int = 50
    bf16: bool = True
    tasks: Tuple[TaskConfig, ...] = ()


def default_task_configs() -> Tuple[TaskConfig, ...]:
    """The four tasks with their monitors; pose trains with AdamW, a
    per-step one-cycle schedule and the ViT at 0.1x lr (``total_steps`` and
    ``warmup_steps`` are filled in by the caller)."""
    return (
        TaskConfig(name="person_detection", monitor="val/mAP50-95", monitor_mode="max"),
        TaskConfig(name="face_detection", monitor="val/mAP50-95", monitor_mode="max"),
        TaskConfig(name="face_recognition", monitor="val_acc", monitor_mode="max"),
        TaskConfig(
            name="pose_estimation", monitor="val_loss", monitor_mode="min",
            optim=OptimConfig(
                optimizer="adamw", weight_decay=5e-4, schedule="onecycle",
                param_group_scales=(("vit_pose", 0.1),),
            ),
        ),
    )


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


@dataclass(frozen=True)
class RTDETRConfig:
    """RT-DETR as the cascade's person detector (``nn/rtdetr.py``): the
    widths of ``rtdetr_r50vd_6x_coco.yml`` (RT-DETR-R50). Port-only: the JAX
    package has no detection transformer."""

    num_classes: int = 80
    # the class whose sigmoid score the cascade serves as a person
    person_label: int = 0
    hidden: int = 256
    num_queries: int = 300
    heads: int = 8
    ffn: int = 1024
    levels: int = 3
    points: int = 4
    num_decoder_layers: int = 6


@dataclass(frozen=True)
class FrameworkConfig:
    model: CombinedModelConfig = field(default_factory=CombinedModelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(x) for x in obj]
    return obj


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_dict(cfg), indent=2)


def _from_dict(cls: type, data: Dict[str, Any]) -> Any:
    """The JAX package's reader, kept as it is: it rebuilds a nested config
    only where the field's annotation is a class, which under postponed
    annotations it never is, so nested configs come back as dicts."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            v = _from_dict(f.type, v)
        kwargs[f.name] = v
    return cls(**kwargs)
