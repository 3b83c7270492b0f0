"""Standalone YOLOv11 trainer (``prpe_tpu/cli/train_yolo.py``, the
reference's "yolopt" stack).

    python -m prpe_tpu_torch.cli.train_yolo --data-dir DIR [--device cpu]
        [--variant n] [--input-size 640] [--batch-size 32] [--epochs 100]
    python -m prpe_tpu_torch.cli.train_yolo --data-dir DIR --test
        [--checkpoint PATH] [--class-names person]

The JAX CLI's flags plus ``--device`` (CUDA unless the caller names
another). Feature parity with the reference trainer
(training/yolopt/main.py:21-166):

  * YOLOv11-n..x at 640^2 directly on images, fp32
  * SGD + Nesterov with no weight decay on biases and norm scales, a
    linear warm-up then a linear decay
  * an EMA of the weights (decay 0.9999, tau 2000), which validation runs
    with the live model's BatchNorm statistics
  * gradient accumulation to 64 images: round(64 / batch) calls per update;
    the update count and the EMA advance on every call
  * mosaic, MixUp, affine, HSV and the rare visual transforms on the train
    set (``data/detection.py::YoloMosaicDataset``), the mosaic off for the
    last 10 epochs (reference: main.py:76-78)
  * after each epoch NMS (the CUDA kernel on the card) and the mAP hook,
    ``step.csv``, and the ``last`` and ``best`` checkpoints (the EMA weights
    with the live statistics, ``train/checkpoint.py::save_model``)
  * ``--test``: the val set's metrics and the PR, F1, P and R curve PNGs of
    a checkpoint (matplotlib)

The training and eval steps are importable (``train_step``, ``eval_step``,
``evaluate``). The JAX CLI's data-axis mesh comes with the parallel slice.
"""

from __future__ import annotations

import argparse
import csv
import pathlib
import sys
from dataclasses import dataclass
from typing import Any, Dict, List

import torch

# the keys of a detection batch the mAP hook reads
GT_KEYS = ("gt_labels", "gt_boxes", "gt_mask")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default="dataset_folders/coco_person")
    ap.add_argument("--input-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--variant", default="n", choices=list("ntsmlx"))
    ap.add_argument("--num-classes", type=int, default=1)
    ap.add_argument("--max-lr", type=float, default=1e-2)
    ap.add_argument("--min-lr", type=float, default=1e-4)
    ap.add_argument("--warmup-epochs", type=float, default=3.0)
    ap.add_argument("--weight-decay", type=float, default=5e-4)
    ap.add_argument("--max-train-samples", type=int, default=None)
    ap.add_argument("--max-val-samples", type=int, default=None)
    ap.add_argument("--output-dir", default="weights")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic data (smoke test)")
    ap.add_argument("--test", action="store_true",
                    help="eval-only: load --checkpoint (default <output-dir>/best), run val "
                         "mAP, save PR/F1/P/R curve PNGs (reference: yolopt/main.py:169-239)")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file for --test (train/checkpoint.py::save_model's "
                         "format, or a bare state dict)")
    ap.add_argument("--class-names", default=None,
                    help="comma-separated class names for plot legends")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


@dataclass
class YoloTrainState:
    """What the JAX CLI's loop carries besides the model: the optimizer
    state, the EMA of the parameters and the update count."""

    opt_state: Any
    ema_params: Dict[str, torch.Tensor]
    updates_count: int = 0


def build_model(num_classes: int, variant: str, device, seed: int = 0):
    """YOLOv11 of ``variant`` in fp32, weights drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    from prpe_tpu_torch.nn.common import build_on
    from prpe_tpu_torch.nn.yolo import YOLO

    return build_on(torch.device(device), lambda: YOLO(nc=num_classes, variant=variant), seed)


def create_state(model, tx) -> YoloTrainState:
    params = dict(model.named_parameters())
    return YoloTrainState(opt_state=tx.init(params),
                          ema_params={n: p.detach().clone() for n, p in params.items()})


def train_step(model, tx, state: YoloTrainState, batch, det_cfg) -> Dict[str, torch.Tensor]:
    """One call of the JAX CLI's ``train_step``: the loss of a train-mode
    forward (batch statistics, running statistics updated), its gradient,
    ``tx``'s update added in place (zero on the calls where the
    accumulation holds it back), then the update count and the EMA
    advanced. Returns the loss and its parts as 0-d tensors on the device."""
    from prpe_tpu_torch.data.packed import apply_image_norm
    from prpe_tpu_torch.ops import losses as L
    from prpe_tpu_torch.train.state import update_ema
    from prpe_tpu_torch.train.steps import to_device

    device = next(model.parameters()).device
    batch = to_device(batch, device)
    model.train()
    params = dict(model.named_parameters())
    # loaders ship raw uint8; /255 on the device
    outs = model(apply_image_norm(batch["image"], "unit"))
    dl = L.yolo_detection_loss(outs, batch["gt_labels"], batch["gt_boxes"], batch["gt_mask"],
                               num_classes=det_cfg.num_classes, box_gain=det_cfg.box_gain,
                               cls_gain=det_cfg.cls_gain, dfl_gain=det_cfg.dfl_gain)
    grads = torch.autograd.grad(dl.total, list(params.values()))
    updates, state.opt_state = tx.update(dict(zip(params, grads)), state.opt_state, params)
    with torch.no_grad():
        torch._foreach_add_(list(params.values()), [updates[n] for n in params])
    state.updates_count += 1
    update_ema(state.ema_params, params, state.updates_count)
    return {"loss": dl.total.detach(), "box": dl.box.detach(), "cls": dl.cls.detach(),
            "dfl": dl.dfl.detach()}


@torch.no_grad()
def eval_step(model, params: Dict[str, torch.Tensor], batch, det_cfg):
    """The JAX CLI's ``eval_step``: an eval-mode forward with ``params``
    (the EMA) in place of the model's parameters and the model's running
    statistics, decoded and put through NMS (the CUDA kernel on the card,
    ``pre_nms_top_k`` candidates an image) -> ``Detections``."""
    from torch.func import functional_call

    from prpe_tpu_torch.data.packed import apply_image_norm
    from prpe_tpu_torch.nn.yolo import decode_predictions
    from prpe_tpu_torch.ops.nms import non_max_suppression
    from prpe_tpu_torch.train.steps import to_device

    device = next(model.parameters()).device
    model.eval()
    image = apply_image_norm(to_device({"image": batch["image"]}, device)["image"], "unit")
    outs = functional_call(model, params, (image,))
    return non_max_suppression(
        decode_predictions(outs, det_cfg.num_classes), conf_threshold=det_cfg.conf_threshold,
        iou_threshold=det_cfg.iou_threshold, max_det=det_cfg.max_det,
        pre_nms_top_k=det_cfg.pre_nms_top_k)


def val_outputs(model, params, val_loader, det_cfg, epoch: int = 0) -> List:
    """(host ``Detections``, host ground truth) of each val batch, as the
    mAP hook reads them."""
    from prpe_tpu_torch.train.round_robin import _to_host_tree

    outputs = []
    for batch in val_loader(epoch):
        det = eval_step(model, params, batch, det_cfg)
        outputs.append((_to_host_tree(det), _to_host_tree({k: batch[k] for k in GT_KEYS})))
    return outputs


def evaluate(model, params, val_loader, det_cfg, image_size: int, epoch: int = 0):
    """The ``--test`` evaluation: (metrics, ``DetectionCurves`` or None) of
    the val set."""
    from prpe_tpu_torch.eval.map import collect_per_image, evaluate_detections

    outputs = val_outputs(model, params, val_loader, det_cfg, epoch)
    return evaluate_detections(collect_per_image(outputs, image_size), return_curves=True)


def ema_state_dict(model, state: YoloTrainState) -> Dict[str, torch.Tensor]:
    """The model's state dict with the EMA in place of the parameters: the
    weights validation runs and the checkpoints hold."""
    sd = dict(model.state_dict())
    sd.update(state.ema_params)
    return sd


def build_loaders(args, det_cfg, device):
    """(train dataset or None, train loader, val loader, steps per epoch)
    as in the JAX CLI: synthetic batches (8 a train epoch, 2 a val pass)
    with ``--synthetic``, else the mosaic view of ``--data-dir``'s train
    split and its plain val split, batches prefetched to ``device``."""
    from prpe_tpu_torch.data import pipeline, synthetic
    from prpe_tpu_torch.data.detection import YoloMosaicDataset, YoloTxtDataset

    if args.synthetic:
        kw = dict(batch_size=args.batch_size, image_size=args.input_size,
                  max_gt=det_cfg.max_gt)
        return (None, synthetic.make_loader("person_detection", batches_per_epoch=8, **kw),
                synthetic.make_loader("person_detection", batches_per_epoch=2, seed=9, **kw), 8)
    base = YoloTxtDataset(args.data_dir, "train", args.input_size, det_cfg.max_gt)
    train_ds = YoloMosaicDataset(base)
    val_ds = YoloTxtDataset(args.data_dir, "val", args.input_size, det_cfg.max_gt)
    train_loader = pipeline.make_epoch_loader(train_ds, args.batch_size,
                                              max_samples=args.max_train_samples, device=device)
    val_loader = pipeline.make_epoch_loader(val_ds, args.batch_size,
                                            max_samples=args.max_val_samples, shuffle=False,
                                            device=device)
    # the batches the loader gives: the JAX CLI counts max_train_samples
    # even where it exceeds the dataset (prpe_tpu/cli/train_yolo.py:103-104)
    return train_ds, train_loader, val_loader, max(1, train_loader.steps_per_epoch)


def main(argv=None) -> int:
    args = parse_args(argv)

    from prpe_tpu_torch.core.config import DetectionConfig, OptimConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.eval.map import detection_eval_hook
    from prpe_tpu_torch.train.checkpoint import load_model, save_model
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.utils.profiling import count_flops, count_params

    device = resolve_device(args.device)
    det_cfg = DetectionConfig(num_classes=args.num_classes, variant=args.variant,
                              image_size=args.input_size)
    model = build_model(args.num_classes, args.variant, device)
    # startup profile line (reference: yolopt/main.py:242-256 thop profile())
    x0 = torch.zeros((1, args.input_size, args.input_size, 3), device=device)
    cost = count_flops(model, x0)
    print(f"params: {count_params(model.parameters()) / 1e6:.2f}M  "
          f"flops/img: {cost['flops'] / 1e9:.2f}G", flush=True)

    accumulate = max(1, round(64 / args.batch_size))
    train_ds, train_loader, val_loader, steps_per_epoch = build_loaders(args, det_cfg, device)
    mosaic_off_epoch = max(0, args.epochs - 10)

    out_dir = pathlib.Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.test:
        # eval-only entry (reference: yolopt/main.py:169-239 test(): loads
        # best.pt, fuses conv+BN, evaluates, plots the curves); the eval
        # forward folds BatchNorm into scale and bias
        from prpe_tpu_torch.eval.plots import save_detection_curves

        model.load_state_dict(load_model(args.checkpoint or (out_dir / "best")))
        metrics, curves = evaluate(model, dict(model.named_parameters()), val_loader, det_cfg,
                                   args.input_size)
        names = args.class_names.split(",") if args.class_names else None
        paths = save_detection_curves(curves, out_dir, names)
        print(("%10s" * 5) % ("", "precision", "recall", "mAP50", "mAP"))
        print(("%10s" + "%10.3g" * 4) % ("", metrics["precision"], metrics["recall"],
                                          metrics["mAP50"], metrics["mAP50-95"]))
        for k, v in paths.items():
            print(f"{k}: {v}")
        return 0

    ocfg = OptimConfig(
        optimizer="sgd", learning_rate=args.max_lr, weight_decay=args.weight_decay,
        schedule="linear", min_lr=args.min_lr,
        warmup_steps=int(max(args.warmup_epochs * steps_per_epoch, 100)),
        total_steps=args.epochs * steps_per_epoch, accumulate=accumulate)
    tx = build_optimizer(ocfg)
    state = create_state(model, tx)
    csv_path = out_dir / "step.csv"
    hook = detection_eval_hook(args.input_size)
    best_map = -1.0

    for epoch in range(args.epochs):
        if train_ds is not None and epoch >= mosaic_off_epoch:
            train_ds.set_mosaic(0.0)
        step_metrics = [train_step(model, tx, state, batch, det_cfg)
                        for batch in train_loader(epoch)]
        train_means = {}
        if step_metrics:  # one device-to-host copy, then the JAX CLI's float sums
            keys = list(step_metrics[0])
            rows = torch.stack([torch.stack([m[k] for k in keys]) for m in step_metrics]).tolist()
            train_means = {k: sum(r[i] for r in rows) / len(rows) for i, k in enumerate(keys)}

        outputs = val_outputs(model, state.ema_params, val_loader, det_cfg, epoch)
        val = hook(outputs) if outputs else {}

        row = {"epoch": epoch, **train_means, **val}
        exists = csv_path.exists()
        with csv_path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if not exists:
                w.writeheader()
            w.writerow({k: (f"{v:.5f}" if isinstance(v, float) else v) for k, v in row.items()})
        print(row, flush=True)

        save = ema_state_dict(model, state)
        save_model(out_dir / "last", save)
        if val.get("mAP50-95", 0.0) > best_map:
            best_map = val.get("mAP50-95", 0.0)
            save_model(out_dir / "best", save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
