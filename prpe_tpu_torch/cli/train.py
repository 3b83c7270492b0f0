"""Round-robin multi-task training of the combined model.

    python -m prpe_tpu_torch.cli.train [--device cpu] [--preset tiny]
        [--epochs N] [--batch-size B] [--image-size S] [--tasks a,b]
        [--checkpoint-dir DIR] [--resume-checkpoint latest|NAME]
        [--data-parallel DP] [--model-parallel MP] [--coordinator HOST:PORT
        --num-processes N --process-id I] [--device-resident] ...

The JAX package's training CLI (``prpe_tpu/cli/train.py``) with the same
flags, plus ``--device`` (CUDA unless the caller names another). Several
processes, one per device, train as one over a
(data, model) mesh: start one process per device with ``--coordinator``,
``--num-processes`` and ``--process-id``, or under ``torchrun`` (which sets
``RANK`` and ``WORLD_SIZE``), and give the mesh with ``--data-parallel``
(-1: every process) and ``--model-parallel`` (the AdaFace classifier split
by class). ``--batch-size`` is the global batch; each data rank takes
``batch / dp`` rows of it. Each task reads its
dataset directory (``--person-data-dir`` and ``--face-data-dir``: YOLO-txt,
``--face-rec-data-dir``: identity folders, ``--pose-data-dir``: COCO
keypoints; PNG and BMP decode without PIL, JPEG needs it); its batches are
decoded by ``--num-workers`` forked workers (0: on the prefetch thread) and
copied to the card on a side stream. A task whose directory holds no
dataset trains on deterministic synthetic batches (``data/synthetic.py``),
eight a train epoch and two a validation pass, as in the JAX package.
Validation adds the JAX CLI's hooks: detection mAP (``val/mAP50-95``, the
detection tasks' monitor, synthetic data included), face verification
(``val/ver_acc``) and COCO keypoint AP (``val/kpt_AP``) with their
datasets.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_task_loaders(args, cfg, device=None, mesh=None):
    """Per task, its train and val loaders and eval hook: the dataset
    readers where the task's directory holds a dataset (batches prefetched
    to ``device``; under a ``mesh`` this data rank's ``batch / dp`` rows of
    each global batch, from its data rank's stride of the samples, which
    the ranks of one model group share), else deterministic synthetic
    global batches. Hooks and val loaders as in the JAX package's
    CLI: the mAP hook on both detection tasks, synthetic or not; the
    verification and keypoint hooks, and the pose val loader, only with
    their datasets."""
    from prpe_tpu_torch.data import pipeline, synthetic
    from prpe_tpu_torch.data.detection import YoloTxtDataset
    from prpe_tpu_torch.data.faces import IdentityFolderDataset
    from prpe_tpu_torch.data.pose import CocoKeypointDataset
    from prpe_tpu_torch.eval.map import detection_eval_hook
    from prpe_tpu_torch.eval.pose_hook import pose_eval_hook
    from prpe_tpu_torch.eval.verification import face_verification_hook

    def epochs(dataset, max_samples, train):
        return pipeline.make_epoch_loader(
            dataset, args.batch_size // (mesh.dp if mesh else 1), max_samples=max_samples,
            shuffle=train, device=device, num_workers=args.num_workers if train else 0,
            shard=(mesh.data_rank, mesh.dp) if mesh else None)

    loaders = {}

    def detection(task, root):
        try:
            train = YoloTxtDataset(root, "train", args.image_size, cfg.detection.max_gt,
                                   augment=True)
            val = YoloTxtDataset(root, "val", args.image_size, cfg.detection.max_gt)
            return {"train": epochs(train, args.max_train_samples, True),
                    "val": epochs(val, args.max_val_samples, False),
                    "eval_hook": detection_eval_hook(args.image_size)}
        except FileNotFoundError:
            print(f"[{task}] dataset not found at {root}; using synthetic data")
            kw = dict(batch_size=args.batch_size, image_size=args.image_size,
                      max_gt=cfg.detection.max_gt)
            return {"train": synthetic.make_loader(task, batches_per_epoch=8, **kw),
                    "val": synthetic.make_loader(task, batches_per_epoch=2, seed=9, **kw),
                    "eval_hook": detection_eval_hook(args.image_size)}

    loaders["person_detection"] = detection("person_detection", args.person_data_dir)
    loaders["face_detection"] = detection("face_detection", args.face_data_dir)

    try:
        ftrain = IdentityFolderDataset(args.face_rec_data_dir, "train", augment=True)
        fval = IdentityFolderDataset(args.face_rec_data_dir, "val")
        loaders["face_recognition"] = {"train": epochs(ftrain, args.max_train_samples, True),
                                       "val": epochs(fval, args.max_val_samples, False),
                                       "eval_hook": face_verification_hook()}
    except (FileNotFoundError, StopIteration, OSError):
        print(f"[face_recognition] dataset not found at {args.face_rec_data_dir}; synthetic")
        kw = dict(batch_size=args.batch_size, image_size=args.image_size,
                  num_classes=cfg.face.num_classes)
        loaders["face_recognition"] = {
            "train": synthetic.make_loader("face_recognition", batches_per_epoch=8, **kw),
            "val": synthetic.make_loader("face_recognition", batches_per_epoch=2, seed=9, **kw)}

    try:
        ptrain = CocoKeypointDataset(args.pose_data_dir, "train", image_size=args.image_size,
                                     max_instances=cfg.pose.max_instances, augment=True)
        pval = CocoKeypointDataset(args.pose_data_dir, "val", image_size=args.image_size,
                                   max_instances=cfg.pose.max_instances)
        loaders["pose_estimation"] = {"train": epochs(ptrain, args.max_train_samples, True),
                                      "val": epochs(pval, args.max_val_samples, False),
                                      "eval_hook": pose_eval_hook(args.image_size,
                                                                  args.keypoint_thresh)}
    except (FileNotFoundError, OSError):
        print(f"[pose_estimation] dataset not found at {args.pose_data_dir}; synthetic")
        loaders["pose_estimation"] = {
            "train": synthetic.make_loader("pose_estimation", batches_per_epoch=8,
                                           batch_size=args.batch_size,
                                           image_size=args.image_size,
                                           max_instances=cfg.pose.max_instances)}
    return loaders


def close_loaders(loaders) -> None:
    """Stop every loader's decode workers (synthetic loaders have none)."""
    for task_loaders in loaders.values():
        for key in ("train", "val"):
            fn = task_loaders.get(key)
            if fn is not None and hasattr(fn, "close"):
                fn.close()


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
                    help="decode worker processes per train loader of a dataset on disk "
                         "(forked at start-up; 0 decodes on the prefetch thread; the "
                         "synthetic loaders have none)")
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
    ap.add_argument("--device-resident", action="store_true",
                    help="stage one epoch of every task on the card before the model is "
                         "built and replay it each epoch (augmentation frozen to the staged "
                         "epoch): the host's decoding then stays out of the steps, for "
                         "datasets that fit the card (data/pipeline.py::"
                         "device_resident_loader)")
    ap.add_argument("--device-resident-refresh", action="store_true",
                    help="with --device-resident: fresh augmentation each epoch (the "
                         "reference regimen, yolopt/dataset.py:105-176): a host thread "
                         "augments epoch N+1 during epoch N, its batches copied to the "
                         "card on a side stream between steps; an epoch that starts "
                         "before it is done replays the last one. Needs twice the staged "
                         "memory")
    ap.add_argument("--device-resident-max-gb", type=float, default=8.0,
                    help="refuse --device-resident beyond this total staged size (GiB; "
                         "the model, its optimizer states and the activations need the "
                         "rest of the card's memory)")
    # (data, model) mesh over the processes (DDP + SyncBN semantics, the
    # reference's training/yolopt/main.py:46-60)
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="data-axis size; -1 = every process; 0 = no mesh")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size (splits the AdaFace classifier by class)")
    # rendezvous (the reference's torch.distributed env:// init,
    # training/yolopt/main.py:271-277)
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0's rendezvous (tcp://), or an init URL "
                         "such as file:///shared/path; without it, torchrun's environment")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, cuda:LOCAL_RANK under a rendezvous)")
    return ap.parse_args(argv)


def _setup_mesh(args):
    """-> (device, mesh, whether this call started the process group).

    A rendezvous (``--coordinator`` / ``--num-processes``, or torchrun's
    ``WORLD_SIZE``) joins the process group, each process on its own card
    unless ``--device`` names one; a failed rendezvous raises. A process
    group that the caller started stays the caller's. A mesh asked for
    without one runs on a process group of this process alone, so that its
    collectives run all the same."""
    import os

    import torch.distributed as dist

    from prpe_tpu_torch.core.config import MeshConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.parallel import distributed
    from prpe_tpu_torch.parallel.mesh import build_mesh

    device = resolve_device(args.device)
    started = False
    want_mesh = args.data_parallel != 0 or args.model_parallel > 1
    if args.coordinator or args.num_processes or "WORLD_SIZE" in os.environ:
        named = args.device is not None and ":" in args.device
        started = not dist.is_initialized()  # a caller's process group stays the caller's
        distributed.initialize(args.coordinator, args.num_processes, args.process_id,
                               device=device if named or device.type == "cpu" else None)
        device = distributed.local_device() or device
    elif want_mesh and not dist.is_initialized():
        distributed.initialize(None, 1, 0, device=device)
        started = True
    try:
        if not want_mesh:
            if dist.is_initialized() and dist.get_world_size() > 1:
                raise SystemExit(f"{dist.get_world_size()} processes train as one only over "
                                 "a mesh: pass --data-parallel -1 (or a size)")
            return device, None, started
        mesh = build_mesh(MeshConfig(data_parallel=args.data_parallel or -1,
                                     model_parallel=args.model_parallel), device=device)
        if args.batch_size % mesh.dp:
            raise SystemExit(f"--batch-size {args.batch_size} does not split over "
                             f"{mesh.dp} data ranks")
    except BaseException:
        if started:
            distributed.shutdown()
        raise
    if mesh.is_primary:
        print(f"mesh: {dict(zip(mesh.axis_names, mesh.shape))}", flush=True)
    return device, mesh, started


def stage_on_device(args, loaders, device, mesh) -> int:
    """``--device-resident``: every loader staged on ``device`` (this rank's
    rows), refused beyond ``--device-resident-max-gb``. Returns the staged
    bytes."""
    from prpe_tpu_torch.data.pipeline import device_resident_loader
    from prpe_tpu_torch.parallel.mesh import shard_batch

    budget = args.device_resident_max_gb * 2 ** 30
    total = 0
    for tname, tl in loaders.items():
        for split in ("train", "val"):
            if tl.get(split) is None:
                continue
            per_rank = mesh is None or getattr(tl[split], "per_rank", False)
            tl[split] = device_resident_loader(
                tl[split], device=device, reshuffle=split == "train", seed=args.seed,
                name=f"{tname}/{split}",
                refresh=args.device_resident_refresh and split == "train",
                shard=None if per_rank else (lambda b: shard_batch(b, mesh)))
            total += tl[split].total_bytes
            if total > budget:  # checked per loader: stop before the card is full
                raise SystemExit(
                    f"--device-resident exceeded --device-resident-max-gb "
                    f"{args.device_resident_max_gb} ({total / 2**30:.2f} GiB staged at "
                    f"{tname}/{split}); lower --max-train-samples/--image-size or drop the "
                    "flag")
    print(f"[device-resident] total staged: {total / 2**20:.0f} MiB", flush=True)
    return total


def main(argv=None) -> int:
    args = parse_args(argv)

    from prpe_tpu_torch.parallel import distributed

    device, mesh, started = _setup_mesh(args)
    loaders = {}
    try:
        cfg = model_config(args)
        loaders = build_task_loaders(args, cfg, device, mesh=mesh)
        if args.tasks:
            keep = [t.strip() for t in args.tasks.split(",") if t.strip()]
            unknown = [t for t in keep if t not in loaders]
            if unknown:
                raise SystemExit(f"--tasks: unknown task(s) {unknown}; "
                                 f"choose from {sorted(loaders)}")
            loaders = {k: v for k, v in loaders.items() if k in keep}
        if args.device_resident:
            # staged before the model is built: the card's memory is free
            stage_on_device(args, loaders, device, mesh)
        return _train(args, cfg, device, loaders, mesh)
    finally:
        close_loaders(loaders)
        for key, tl in ((k, tl) for tl in loaders.values() for k in ("train", "val")):
            stats = getattr(tl.get(key), "stats", None)
            if stats is not None and "fresh_epochs" in stats:
                print(f"[device-resident] {key} staging stats: fresh_epochs="
                      f"{stats['fresh_epochs']} stale_epochs={stats['stale_epochs']}",
                      flush=True)
        if started:
            distributed.shutdown()


def _train(args, cfg, device, loaders, mesh=None) -> int:
    from prpe_tpu_torch.cli.build_model import build_variables
    from prpe_tpu_torch.core.config import TrainConfig, default_task_configs
    from prpe_tpu_torch.parallel.mesh import shard_params
    from prpe_tpu_torch.train.round_robin import RoundRobinTrainer

    if args.preset == "tiny":
        from prpe_tpu_torch.models.combined import CombinedModel

        model = CombinedModel(cfg, _DTYPES[args.dtype], device=device, seed=args.seed)
    else:
        model, _ = build_variables(pathlib.Path(args.component_dir), cfg,
                                   dtype=_DTYPES[args.dtype], device=device)
    if mesh is not None:
        # every rank built the same weights from the seed; each keeps its
        # block of the classifier's classes
        shard_params(model, mesh)

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
    trainer = RoundRobinTrainer(model, cfg, tcfg, loaders, log_dir=args.log_dir, mesh=mesh)
    if args.resume_checkpoint:
        trainer.resume(None if args.resume_checkpoint == "latest" else args.resume_checkpoint)
    trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
