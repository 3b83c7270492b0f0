"""Round-robin multi-task training of the combined model.

    python -m prpe_tpu_torch.cli.train [--device cpu] [--preset tiny]
        [--epochs N] [--batch-size B] [--image-size S] [--tasks a,b]
        [--checkpoint-dir DIR] [--resume-checkpoint latest|NAME] ...

The JAX package's training CLI (``prpe_tpu/cli/train.py``) with the same
flags, less the mesh, multi-host and device-resident ones, plus
``--device`` (CUDA unless the caller names another). A task whose dataset
directory does not exist trains on deterministic synthetic batches
(``data/synthetic.py``), eight a train epoch and two a validation pass, as
in the JAX package; a dataset directory that exists is refused until the
dataset readers are ported (ROADMAP.md). Validation metrics are the eval
steps' own (losses, accuracies, PCK); the mAP, face-verification and COCO
keypoint hooks come with the eval slice, so the detection monitors
(``val/mAP50-95``) stay unset and save no ``best_*`` checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _refuse_dataset(task: str, root: str) -> None:
    raise NotImplementedError(
        f"[{task}] a dataset exists at {root}, and the port has no dataset reader yet "
        "(they come with the data slice, ROADMAP.md); move it away to train on "
        "synthetic data")


def build_task_loaders(args, cfg):
    """Per task, the synthetic train (and val) loaders when its dataset
    directory is missing."""
    from prpe_tpu_torch.data import synthetic

    loaders = {}
    for task, root in (("person_detection", args.person_data_dir),
                       ("face_detection", args.face_data_dir)):
        if pathlib.Path(root).exists():
            _refuse_dataset(task, root)
        print(f"[{task}] dataset not found at {root}; using synthetic data")
        kw = dict(batch_size=args.batch_size, image_size=args.image_size,
                  max_gt=cfg.detection.max_gt)
        loaders[task] = {"train": synthetic.make_loader(task, batches_per_epoch=8, **kw),
                         "val": synthetic.make_loader(task, batches_per_epoch=2, seed=9, **kw)}
    if pathlib.Path(args.face_rec_data_dir).exists():
        _refuse_dataset("face_recognition", args.face_rec_data_dir)
    print(f"[face_recognition] dataset not found at {args.face_rec_data_dir}; synthetic")
    kw = dict(batch_size=args.batch_size, image_size=args.image_size,
              num_classes=cfg.face.num_classes)
    loaders["face_recognition"] = {
        "train": synthetic.make_loader("face_recognition", batches_per_epoch=8, **kw),
        "val": synthetic.make_loader("face_recognition", batches_per_epoch=2, seed=9, **kw)}
    if pathlib.Path(args.pose_data_dir).exists():
        _refuse_dataset("pose_estimation", args.pose_data_dir)
    print(f"[pose_estimation] dataset not found at {args.pose_data_dir}; synthetic")
    loaders["pose_estimation"] = {
        "train": synthetic.make_loader("pose_estimation", batches_per_epoch=8,
                                       batch_size=args.batch_size, image_size=args.image_size,
                                       max_instances=cfg.pose.max_instances)}
    return loaders


def model_config(args):
    """The combined model of ``--preset``: ``full`` (ResNet-50, IR-50 with
    85 742 classes, ViTPose-B) or ``tiny`` (a 1-block trunk, IR-18 with 64
    classes, a 1-layer ViT of width 32 at 32x32), at ``--image-size``."""
    from prpe_tpu_torch.core.config import (
        AdaFaceConfig, CombinedModelConfig, DetectionConfig, PoseConfig,
    )

    pose_kw = dict(sigma=args.pose_sigma, keypoint_thresh=args.keypoint_thresh)
    if args.preset == "tiny":
        return CombinedModelConfig(
            image_size=args.image_size, backbone_stages=(1, 1, 1, 1),
            remat_backbone=not args.no_remat,
            detection=DetectionConfig(adapter_size=(args.image_size // 2, args.image_size // 2),
                                      max_gt=4),
            face=AdaFaceConfig(arch="ir_18", num_classes=64),
            pose=dataclasses.replace(
                PoseConfig(input_size=(32, 32), heatmap_size=(8, 8), vit_hidden=32,
                           vit_layers=1, vit_heads=2), **pose_kw))
    return CombinedModelConfig(image_size=args.image_size, remat_backbone=not args.no_remat,
                               pose=dataclasses.replace(PoseConfig(), **pose_kw))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--person-data-dir", default="dataset_folders/coco_person")
    ap.add_argument("--face-data-dir", default="dataset_folders/yolo_face")
    ap.add_argument("--face-rec-data-dir", default="dataset_folders/ms1mv2")
    ap.add_argument("--pose-data-dir", default="dataset_folders/coco")
    ap.add_argument("--max-train-samples", type=int, default=2500)
    ap.add_argument("--max-val-samples", type=int, default=400)
    ap.add_argument("--pose-sigma", type=float, default=2.0)
    ap.add_argument("--keypoint-thresh", type=float, default=0.3)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--save-every", type=int, default=1,
                    help="save the combined checkpoint every N epochs (a full-width "
                         "checkpoint with its optimizer states is about 2 GB)")
    ap.add_argument("--resume-checkpoint", default=None,
                    help="'latest' (the newest in --checkpoint-dir) or a checkpoint name")
    ap.add_argument("--component-dir", default="component_models")
    ap.add_argument("--log-dir", default="runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tasks", default=None,
                    help="comma-separated subset of tasks to round-robin (default: all four)")
    ap.add_argument("--num-workers", type=int, default=0,
                    help="decode worker processes per train loader (used by the dataset "
                         "readers; the synthetic loaders ignore it)")
    ap.add_argument("--dtype", choices=tuple(_DTYPES), default="bfloat16",
                    help="compute dtype; parameters stay fp32")
    ap.add_argument("--preset", choices=("full", "tiny"), default="full",
                    help="'tiny' = a 1-block trunk, IR-18, a 1-layer ViT and a 64-class "
                         "head, for CPU runs; component checkpoints are not ported")
    ap.add_argument("--no-remat", action="store_true",
                    help="no trunk recomputation on the backward (only matters when the "
                         "trunk trains)")
    ap.add_argument("--trainable", choices=("branch", "branch+backbone", "all"),
                    default="branch",
                    help="per-task optimizer scope; 'branch' leaves the shared trunk in "
                         "no optimizer")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from prpe_tpu_torch.cli.build_model import build_variables
    from prpe_tpu_torch.core.config import TrainConfig, default_task_configs
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.train.round_robin import RoundRobinTrainer

    device = resolve_device(args.device)
    cfg = model_config(args)
    loaders = build_task_loaders(args, cfg)
    if args.tasks:
        keep = [t.strip() for t in args.tasks.split(",") if t.strip()]
        unknown = [t for t in keep if t not in loaders]
        if unknown:
            raise SystemExit(f"--tasks: unknown task(s) {unknown}; choose from {sorted(loaders)}")
        loaders = {k: v for k, v in loaders.items() if k in keep}

    if args.preset == "tiny":
        from prpe_tpu_torch.models.combined import CombinedModel

        model = CombinedModel(cfg, _DTYPES[args.dtype], device=device, seed=args.seed)
    else:
        model, _ = build_variables(pathlib.Path(args.component_dir), cfg,
                                   dtype=_DTYPES[args.dtype], device=device)

    # each task keeps its optimizer's shape (pose: AdamW + one-cycle + the
    # ViT at 0.1x) and takes the CLI's lr; the schedule's horizon is the
    # loader's steps per epoch times the epochs, warm-up min(1000, 1/5)
    def task_total_steps(name: str) -> int:
        fallback = max(1, args.max_train_samples // args.batch_size)
        per_epoch = getattr(loaders[name]["train"], "steps_per_epoch", fallback)
        return max(1, args.epochs * max(1, per_epoch))

    tasks = tuple(
        dataclasses.replace(
            t,
            optim=dataclasses.replace(
                t.optim, learning_rate=args.learning_rate,
                total_steps=task_total_steps(t.name),
                warmup_steps=(min(1000, task_total_steps(t.name) // 5)
                              if t.optim.schedule != "constant" else 0)),
            trainable=args.trainable)
        for t in default_task_configs() if t.name in loaders)
    tcfg = TrainConfig(total_epochs=args.epochs, seed=args.seed,
                       checkpoint_dir=args.checkpoint_dir, tasks=tasks,
                       save_every_epochs=args.save_every)
    trainer = RoundRobinTrainer(model, cfg, tcfg, loaders, log_dir=args.log_dir)
    if args.resume_checkpoint:
        trainer.resume(None if args.resume_checkpoint == "latest" else args.resume_checkpoint)
    trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
