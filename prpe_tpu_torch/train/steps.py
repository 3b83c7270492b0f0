"""Per-task train and eval steps (``prpe_tpu/train/steps.py``).

Each task has its own step over the one shared model. A train step puts
the whole model in train mode (every BatchNorm on batch statistics, the
frozen trunk's included, as ``train=True`` does in JAX), marks only the
task's trainable parameters as requiring gradients (so no backward runs
through the frozen ones), takes the gradient of the task's loss, runs the
task's optimizer over those parameters and adds the updates in place.

Each detection task has its own step: the JAX package shares one compiled
program between the two (an XLA compile saving); eager steps have nothing
to share.

Under a mesh (``model.mesh``, set by ``parallel.mesh.shard_params``) a step
runs on this rank's rows of the global batch, as the JAX step runs on its
shard: the losses' normalisers, BatchNorm's statistics and the margin's are
the global batch's, each rank's loss is its share of the global loss, the
gradients are all-reduced over the data axis before the update, the
clip's and ``grad_norm``'s norm covers the whole class-split
``face_kernel``, the dropout masks are the global batch's rows, and the
metrics are summed over the data axis, so every rank logs the global
values.

Batch schemas (numpy or torch; moved to the model's device):
  detection:        image (B, H, W, 3), gt_labels (B, M), gt_boxes (B, M, 4)
                    normalised cxcywh, gt_mask (B, M)
  face_recognition: image (B, H, W, 3), label (B,)
  pose_estimation:  image (B, H, W, 3), keypoints (B, N, K, 3), boxes
                    (B, N, 4), areas (B, N), mask (B, N)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch
from torch import nn

from prpe_tpu_torch.core.config import CombinedModelConfig
from prpe_tpu_torch.data.packed import apply_image_norm
from prpe_tpu_torch.nn.common import Dropout, set_dropout_rows
from prpe_tpu_torch.nn.yolo import decode_predictions
from prpe_tpu_torch.ops import heatmap as heatmap_ops
from prpe_tpu_torch.ops import losses as L
from prpe_tpu_torch.ops import margin as margin_ops
from prpe_tpu_torch.ops.nms import non_max_suppression
from prpe_tpu_torch.parallel import collectives as C
from prpe_tpu_torch.parallel import mesh as mesh_lib
from prpe_tpu_torch.train.optim import Transform, global_norm
from prpe_tpu_torch.train.state import TrainState, update_ema

DETECTION_TASKS = ("person_detection", "face_detection")

# the normalisation each task's dataset applies on the host; uint8 batches
# get it on the device (data/packed.py)
TASK_IMAGE_NORM = {
    "person_detection": "unit",
    "face_detection": "unit",
    "face_recognition": "half",
    "pose_estimation": "imagenet",
}

# the top-level parameter subtrees each task's optimizer covers: its branch
# (adapter + network [+ the face prototypes]); the shared trunk is in none
TASK_BRANCHES = {
    "person_detection": ("yolo_person", "yolo_person_adapter"),
    "face_detection": ("yolo_face", "yolo_face_adapter"),
    "face_recognition": ("ada_face", "ada_face_adapter", "face_kernel"),
    "pose_estimation": ("vit_pose", "vit_pose_adapter"),
}


def trainable_mask(model: nn.Module, task: str, scope: str = "branch") -> Dict[str, bool]:
    """Parameter name -> whether ``task``'s optimizer trains it. ``scope``:
    ``branch`` (the branch only), ``branch+backbone`` (and the shared
    trunk) or ``all``."""
    names = [n for n, _ in model.named_parameters()]
    if scope == "all":
        return dict.fromkeys(names, True)
    keys = set(TASK_BRANCHES[task])
    if scope == "branch+backbone":
        keys.add("backbone")
    elif scope != "branch":
        raise ValueError(f"unknown trainable scope {scope!r}")
    return {n: n.split(".")[0] in keys for n in names}


def trainable_params(model: nn.Module, task: str, scope: str = "branch") -> Dict[str, nn.Parameter]:
    mask = trainable_mask(model, task, scope)
    return {n: p for n, p in model.named_parameters() if mask[n]}


def to_device(batch: Mapping[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def set_dropout_generator(model: nn.Module, generator) -> None:
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def _branch(task: str) -> str:
    return "person" if task == "person_detection" else "face"


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32 at least (a float64 model's stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the global batch of a per-row quantity: this rank's
    share of it under a data ``group``."""
    if group is None:
        return x.mean()
    return x.sum() / (x.numel() * C.group_size(group))


def _detection_loss(outs, batch, cfg: CombinedModelConfig, group=None):
    det = cfg.detection
    # the loss in fp32 whatever the compute dtype
    dl = L.yolo_detection_loss(
        [o.float() for o in outs], batch["gt_labels"], batch["gt_boxes"], batch["gt_mask"],
        num_classes=det.num_classes, reg_max=det.reg_max, box_gain=det.box_gain,
        cls_gain=det.cls_gain, dfl_gain=det.dfl_gain, assigner_top_k=det.assigner_top_k,
        assigner_alpha=det.assigner_alpha, assigner_beta=det.assigner_beta, group=group)
    return dl.total, {"loss": dl.total, "box_loss": dl.box, "cls_loss": dl.cls,
                      "dfl_loss": dl.dfl}


def _pose_loss(pred_hm, batch, cfg: CombinedModelConfig, group=None):
    pose = cfg.pose
    kpts = batch["keypoints"]
    coords, vis = kpts[..., :2], kpts[..., 2]
    target_hm, target_w = heatmap_ops.generate_target_heatmaps(
        coords, vis, batch["areas"], heatmap_size=pose.heatmap_size, sigma=pose.sigma)
    pred_hm = _acc(pred_hm)
    hm_loss = L.joints_mse_loss(pred_hm, target_hm, target_w, use_ohkm=pose.use_ohkm,
                                ohkm_topk=pose.ohkm_topk, group=group)
    total = hm_loss
    metrics = {"heatmap_loss": hm_loss}
    # the metrics decode the amplitude-invariant argmax; the OKS term needs
    # the differentiable soft decode
    boxes = batch["boxes"][:, 0]
    pred_coords, _ = heatmap_ops.decode_heatmaps(pred_hm.detach(), boxes=boxes)
    if pose.use_oks_loss:
        soft_coords, _ = heatmap_ops.decode_heatmaps(pred_hm, boxes=boxes, method="soft")
        ol = L.oks_loss(soft_coords, coords[:, 0], vis[:, 0], batch["areas"][:, 0],
                        loss_weight=pose.oks_loss_weight, group=group)
        total = total + ol
        metrics["oks_loss"] = ol
    metrics["loss"] = total
    # the reference's PCK compares normalised distances with a threshold in
    # pixels (kept for its logs); pck_px has both sides in pixels
    metrics["pck"] = L.pck_accuracy(pred_coords, coords[:, 0], vis[:, 0], batch["areas"][:, 0],
                                    group=group)
    img_size = float(batch["image"].shape[1])
    metrics["pck_px"] = L.pck_accuracy(pred_coords * img_size, coords[:, 0] * img_size,
                                       vis[:, 0], batch["areas"][:, 0], group=group)
    return total, metrics


def _mesh_of(model: nn.Module):
    return getattr(model, "mesh", None)


def _face_metrics(logits, labels, model, dgroup):
    """Cross-entropy and accuracy of (class-split) logits, as shares of the
    global batch's means."""
    mgroup = model.model_group
    ce = L.softmax_cross_entropy(logits, labels, model.class_offset, mgroup)
    pred = (logits.argmax(-1) if mgroup is None
            else C.vocab_parallel_argmax(logits, model.class_offset, mgroup))
    return _mean(ce, dgroup), _mean((pred == labels).float(), dgroup)


def make_loss_fn(model: nn.Module, task: str, cfg: CombinedModelConfig) -> Callable:
    """-> ``loss_fn(batch, train) -> (loss, metrics)`` on a batch of tensors
    on the model's device. ``train`` sets the model's mode first. Under a
    mesh the loss and the metrics are this rank's shares of the global
    batch's."""
    mesh = _mesh_of(model)
    dgroup = None if mesh is None else mesh.data_group

    def loss_fn(batch, train: bool = True):
        model.train(train)
        batch = dict(batch)
        batch["image"] = apply_image_norm(batch["image"], TASK_IMAGE_NORM[task])
        if task in DETECTION_TASKS:
            return _detection_loss(model.detect(batch["image"], _branch(task)), batch, cfg,
                                   dgroup)
        if task == "face_recognition":
            logits = _acc(model.face_logits(batch["image"], batch["label"], train=train))
            loss, acc = _face_metrics(logits, batch["label"], model, dgroup)
            return loss, {"loss": loss, "acc": acc}
        if task == "pose_estimation":
            return _pose_loss(model.pose(batch["image"]), batch, cfg, dgroup)
        raise ValueError(f"unknown task {task!r}")

    return loss_fn


def reduce_metrics(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Each rank's shares of the metrics summed over the data ``group``, in
    one collective: the global batch's values on every rank."""
    if group is None:
        return metrics
    keys = list(metrics)
    dtype = torch.float32
    for v in metrics.values():
        dtype = torch.promote_types(dtype, v.dtype)
    flat = C.all_reduce_(torch.stack([metrics[k].detach().to(dtype) for k in keys]), group)
    return dict(zip(keys, flat.unbind()))


def make_train_step(model: nn.Module, task: str, tx: Transform, cfg: CombinedModelConfig, *,
                    use_ema: bool = False, ema_decay: float = 0.9999, ema_tau: float = 2000.0,
                    trainable: str = "branch") -> Callable:
    """-> ``step(state, batch, generator=None) -> (state, metrics)``.

    ``generator`` (a ``torch.Generator`` on the model's device) draws the
    dropout masks. ``metrics`` are 0-d tensors on the device (no host
    sync), with ``grad_norm`` the global norm of the task's gradients.
    Under a mesh ``batch`` holds this data rank's rows, every rank's
    ``generator`` is seeded alike, and ``tx`` clips by the mesh's norm
    (``build_optimizer(norm_fn=...)``, as the trainer builds it).
    """
    loss_fn = make_loss_fn(model, task, cfg)
    mask = trainable_mask(model, task, trainable)
    names = [n for n, m in mask.items() if m]
    device = next(model.parameters()).device
    mesh = _mesh_of(model)
    dgroup = None if mesh is None else mesh.data_group

    def step(state: TrainState, batch, generator=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        all_params = dict(model.named_parameters())
        for n, p in all_params.items():
            p.requires_grad_(mask[n])
        params = {n: all_params[n] for n in names}
        set_dropout_generator(model, generator)
        batch = to_device(batch, device)
        if mesh is not None:
            rows = next(iter(batch.values())).shape[0]
            set_dropout_rows(model, (mesh.data_rank * rows, rows * mesh.dp))
        loss, metrics = loss_fn(batch, True)
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g)
                 for (n, p), g in zip(params.items(), grads)}
        mesh_lib.all_reduce_gradients(grads, mesh)
        updates, state.opt_states[task] = tx.update(grads, state.opt_states[task], params)
        with torch.no_grad():
            torch._foreach_add_(list(params.values()), [updates[n] for n in names])
            if use_ema and state.ema_params is not None:
                state.ema_updates += 1
                update_ema(state.ema_params, all_params, state.ema_updates,
                           decay=ema_decay, tau=ema_tau)
        metrics = reduce_metrics({k: v.detach() for k, v in metrics.items()}, dgroup)
        metrics["grad_norm"] = (global_norm(grads.values()) if mesh is None
                                else mesh_lib.global_norm(grads, mesh))
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model: nn.Module, task: str, cfg: CombinedModelConfig) -> Callable:
    """-> ``step(batch) -> (metrics, predictions)`` in eval mode, without
    gradients: detection -> ``Detections`` with boxes in the image frame;
    face -> the fp32 embeddings; pose -> flip-tested (coords, scores).
    Under a mesh: the predictions of this rank's rows, the metrics the
    global batch's."""
    det = cfg.detection
    device = next(model.parameters()).device
    mesh = _mesh_of(model)
    dgroup = None if mesh is None else mesh.data_group

    @torch.no_grad()
    def step(batch):
        model.eval()
        batch = to_device(batch, device)
        batch["image"] = apply_image_norm(batch["image"], TASK_IMAGE_NORM[task])
        image = batch["image"]
        if task in DETECTION_TASKS:
            outs = model.detect(image, _branch(task))
            _, metrics = _detection_loss(outs, batch, cfg, dgroup)
            detections = non_max_suppression(
                decode_predictions(outs, det.num_classes, det.reg_max),
                conf_threshold=det.conf_threshold, iou_threshold=det.iou_threshold,
                max_det=det.max_det, pre_nms_top_k=det.pre_nms_top_k, max_wh=det.max_wh)
            # YOLO ran on the adapter's pseudo-image: boxes back to the
            # image frame the ground truth is in
            ah, aw = det.adapter_size
            ih, iw = image.shape[1], image.shape[2]
            scale = torch.tensor([iw / aw, ih / ah, iw / aw, ih / ah],
                                 dtype=detections.boxes.dtype, device=device)
            return (reduce_metrics(metrics, dgroup),
                    detections._replace(boxes=detections.boxes * scale))
        if task == "face_recognition":
            # margin-free scaled cosine for the val loss and accuracy; the
            # margin logits' numbers are diagnostics only
            fc = cfg.face
            emb, norms = model.embed_face(image)
            emb32 = _acc(emb)
            kernel = model.face_kernel.to(emb32.dtype)
            logits = margin_ops.normalized_cosine(kernel, emb32) * fc.s
            label = batch["label"]
            mlogits, _ = margin_ops.adaface_logits(
                kernel, emb32, norms.to(emb32.dtype), label,
                margin_ops.MarginState(model.margin_mean, model.margin_std),
                m=fc.m, h=fc.h, s=fc.s, t_alpha=fc.t_alpha, update_stats=False,
                class_offset=model.class_offset)
            loss, acc = _face_metrics(logits, label, model, dgroup)
            loss_m, acc_m = _face_metrics(mlogits, label, model, dgroup)
            metrics = {"loss": loss, "acc": acc, "loss_margin": loss_m, "acc_margin": acc_m}
            return reduce_metrics(metrics, dgroup), emb32
        if task == "pose_estimation":
            hm = model.pose(image)
            _, metrics = _pose_loss(hm, batch, cfg, dgroup)
            # horizontal flip test
            hm_flip = model.pose(torch.flip(image, dims=[2]))
            hm = (hm + heatmap_ops.flip_heatmaps(hm_flip)) * 0.5
            return (reduce_metrics(metrics, dgroup),
                    heatmap_ops.decode_heatmaps(hm.float(), boxes=batch["boxes"][:, 0]))
        raise ValueError(task)

    return step
