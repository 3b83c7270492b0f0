"""Round-robin multi-task trainer (``prpe_tpu/train/round_robin.py``).

Each epoch cycles the tasks in order and trains one epoch-slice of each on
the shared model; every task keeps its own optimizer state across the
cycle; each task's monitor picks its best checkpoint; a combined checkpoint
follows every (epoch, task), and a resume continues with the remaining
tasks of the epoch it stopped in. Tasks that keep an EMA are evaluated on
the EMA weights.

Under a (data, model) mesh (``mesh``; the model already sharded by
``parallel.mesh.shard_params``) every rank runs this loop in step:
``_put_batch`` gives each step the rank's rows of a global batch (a loader
that yields them already says so with ``per_rank``), the steps' metrics are
the global batch's, each eval pass gathers every data rank's host
predictions before its hook, so the hooks score the whole val split, and
the primary rank alone logs and writes checkpoints.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch
from torch import nn

from prpe_tpu_torch.core.config import CombinedModelConfig, TaskConfig, TrainConfig
from prpe_tpu_torch.parallel import collectives as C
from prpe_tpu_torch.parallel import mesh as mesh_lib
from prpe_tpu_torch.train.checkpoint import CheckpointManager
from prpe_tpu_torch.train.metrics import MetricsLogger, MetricTracker, WandbSink, setup_logging
from prpe_tpu_torch.train.optim import build_optimizer
from prpe_tpu_torch.train.state import create_train_state
from prpe_tpu_torch.train.steps import make_eval_step, make_train_step, trainable_params


@dataclass
class TaskRuntime:
    config: TaskConfig
    train_step: Callable
    eval_step: Callable
    train_loader: Callable[[int], Iterable]  # epoch -> iterable of batches
    val_loader: Optional[Callable[[int], Iterable]] = None
    # consumes the list of (predictions, host batch) pairs of an eval pass
    # and returns more metrics (mAP, verification accuracy, ...)
    eval_hook: Optional[Callable[[list], Dict[str, float]]] = None


def _to_host(collected):
    """[(metrics dict of 0-d tensors, batch size)] -> the same with floats,
    in one device-to-host copy."""
    if not collected:
        return []
    keys = list(collected[0][0])
    table = torch.stack([torch.stack([m[k].float() for k in keys]) for m, _ in collected]).cpu()
    return [(dict(zip(keys, row.tolist())), bs) for row, (_, bs) in zip(table, collected)]


def _host_batch(batch):
    """A host copy of a batch for the eval hooks, which read its labels,
    boxes and keypoints, not its images."""
    return _to_host_tree({k: v for k, v in batch.items() if k != "image"})


def _to_host_tree(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bfloat16
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if isinstance(x, dict):
        return {k: _to_host_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host_tree(v) for v in x)
    return x


class RoundRobinTrainer:
    def __init__(self, model: nn.Module, model_cfg: CombinedModelConfig, train_cfg: TrainConfig,
                 task_loaders: Dict[str, Dict[str, Any]], *, log_dir: str = "runs", mesh=None):
        """``model``: the CombinedModel, on its device; ``task_loaders``: per
        task, ``train`` (epoch -> iterable of batches) and optional ``val``
        and ``eval_hook``; ``mesh``: the (data, model) mesh the model is
        sharded over, or None."""
        self.model = model
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.mesh = mesh
        self.primary = mesh is None or mesh.is_primary
        if self.primary:
            self.logger = setup_logging(log_dir)
            self.metrics_logger = MetricsLogger(log_dir)
        else:  # the other ranks log warnings only, and write no file
            self.logger = logging.getLogger(f"prpe_tpu_torch.rank{torch.distributed.get_rank()}")
            self.logger.setLevel(logging.WARNING)
            self.logger.propagate = False
            self.metrics_logger = None
        self.ckpt = CheckpointManager(train_cfg.checkpoint_dir, keep=train_cfg.keep_checkpoints,
                                      mesh=mesh)
        device = next(model.parameters()).device

        tasks = train_cfg.tasks
        # one optimizer per task over that task's trainable parameters; the
        # clip's norm covers the whole class-split face_kernel
        norm_fn = None if mesh is None else (lambda u: mesh_lib.global_norm(u, mesh))
        self.optimizers = {t.name: build_optimizer(t.optim, norm_fn) for t in tasks}
        self.state = create_train_state(
            model, self.optimizers, {t.name: trainable_params(model, t.name, t.trainable)
                                     for t in tasks},
            use_ema=any(t.optim.use_ema for t in tasks))
        self.tasks: Dict[str, TaskRuntime] = {}
        for t in tasks:
            loaders = task_loaders[t.name]
            self.tasks[t.name] = TaskRuntime(
                config=t,
                train_step=make_train_step(model, t.name, self.optimizers[t.name], model_cfg,
                                           use_ema=t.optim.use_ema, ema_decay=t.optim.ema_decay,
                                           ema_tau=t.optim.ema_tau, trainable=t.trainable),
                eval_step=make_eval_step(model, t.name, model_cfg),
                train_loader=loaders["train"],
                val_loader=loaders.get("val"),
                eval_hook=loaders.get("eval_hook"),
            )
        self.wandb = {t.name: WandbSink(t.wandb_project, run_name=f"round_robin_{t.name}")
                      for t in tasks if t.wandb_project and self.primary}
        self.start_epoch = 0
        self._resume_task_index = 0  # first task to run at start_epoch
        self._generator = torch.Generator(device=device)
        self._generator.manual_seed(train_cfg.seed)

    # ----------------------------------------------------------------- #
    def _put_batch(self, batch, loader=None):
        """This data rank's rows of a global host batch (the
        DistributedSampler + DDP scatter equivalent); a batch of a loader
        marked ``per_rank`` holds them already, and without a mesh the
        batch is the step's."""
        if self.mesh is None or getattr(loader, "per_rank", False):
            return batch
        return mesh_lib.shard_batch(batch, self.mesh)

    def _gather(self, items):
        """Every data rank's list of host items, in rank order."""
        if self.mesh is None or self.mesh.data_group is None:
            return items
        return [x for part in C.all_gather_object(items, self.mesh.data_group) for x in part]

    # ----------------------------------------------------------------- #
    def resume(self, path: Optional[str] = None) -> None:
        """Restore the model and state, then continue after the checkpoint's
        (epoch, task): with the next task of that epoch, or the next epoch
        after its last task."""
        self.state, entry = self.ckpt.restore(self.model, self.state, path)
        epoch = int(entry.get("epoch", -1))
        names = list(self.tasks)
        last = entry.get("last_task")
        if last in names and last != names[-1]:
            self.start_epoch = epoch
            self._resume_task_index = names.index(last) + 1
        else:
            self.start_epoch = epoch + 1
            self._resume_task_index = 0
        self.logger.info("resumed from %s (epoch %s, last task %s -> continuing at "
                         "epoch %d task %s)", path or "latest", entry.get("epoch"), last,
                         self.start_epoch, names[self._resume_task_index])

    # ----------------------------------------------------------------- #
    def train_task_epoch(self, epoch: int, name: str) -> Dict[str, float]:
        rt = self.tasks[name]
        tracker = MetricTracker()
        t0 = time.time()
        n_images = 0
        collected = []
        log_every = max(1, self.cfg.log_every_steps)
        for i, batch in enumerate(rt.train_loader(epoch)):
            batch = self._put_batch(batch, rt.train_loader)
            self.state, metrics = rt.train_step(self.state, batch, self._generator)
            # rows of the global batch: every data rank's
            bs = next(iter(batch.values())).shape[0] * (1 if self.mesh is None else self.mesh.dp)
            n_images += bs
            # metrics stay on the device until the epoch ends: one copy
            collected.append((metrics, bs))
            if (i + 1) % log_every == 0:
                self.logger.info("epoch %d | task %s | step %d | loss %.5f (%.0f img/s)",
                                 epoch, name, i + 1, float(metrics["loss"]),
                                 n_images / max(time.time() - t0, 1e-9))
        for m, bs in _to_host(collected):
            tracker.update(m, bs)
        means = {f"train/{k}": v for k, v in tracker.means().items()}
        means["train/images_per_sec"] = n_images / max(time.time() - t0, 1e-9)
        return means

    @contextlib.contextmanager
    def _ema_weights(self, use: bool):
        """The model's parameters replaced by the EMA's inside the block."""
        ema = self.state.ema_params
        if not use or ema is None:
            yield
            return
        params = dict(self.model.named_parameters())
        saved = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(saved[n])

    def eval_task(self, epoch: int, name: str) -> Dict[str, float]:
        rt = self.tasks[name]
        if rt.val_loader is None:
            return {}
        tracker = MetricTracker()
        outputs, collected = [], []
        with self._ema_weights(rt.config.optim.use_ema):
            for batch in rt.val_loader(epoch):
                batch = self._put_batch(batch, rt.val_loader)
                metrics, preds = rt.eval_step(batch)
                collected.append((metrics, next(iter(batch.values())).shape[0]))
                # the hooks read numpy: a host copy of the batch, which the
                # prefetcher may have put on the card
                if rt.eval_hook is not None:
                    outputs.append((_to_host_tree(preds), _host_batch(batch)))
        for m, bs in _to_host(collected):
            tracker.update(m, bs)
        means = {f"val/{k}": v for k, v in tracker.means().items()}
        if rt.eval_hook is not None:
            # every rank scores the whole val split: equal values everywhere
            means.update({f"val/{k}": v for k, v in rt.eval_hook(self._gather(outputs)).items()})
        # the reference's monitor names
        if "val/loss" in means:
            means.setdefault("val_loss", means["val/loss"])
        if "val/acc" in means:
            means.setdefault("val_acc", means["val/acc"])
        return means

    # ----------------------------------------------------------------- #
    def train(self, total_epochs: Optional[int] = None) -> Dict[str, Any]:
        total_epochs = total_epochs or self.cfg.total_epochs
        history = []
        for epoch in range(self.start_epoch, total_epochs):
            for ti, (name, rt) in enumerate(self.tasks.items()):
                if epoch == self.start_epoch and ti < self._resume_task_index:
                    continue  # ran before the checkpoint this run resumed from
                self.logger.info("epoch %d | task %s", epoch, name)
                metrics = self.train_task_epoch(epoch, name)
                metrics.update(self.eval_task(epoch, name))
                if self.metrics_logger is not None:
                    self.metrics_logger.log_epoch(epoch, name, metrics)
                if name in self.wandb:
                    self.wandb[name].log(metrics, step=epoch)
                history.append({"epoch": epoch, "task": name, **metrics})

                # the monitor, else under val/, else val_ for val/ (a value
                # of 0.0 is a value)
                mon = rt.config.monitor
                val = metrics.get(mon)
                if val is None:
                    val = metrics.get(f"val/{mon}")
                if val is None:
                    val = metrics.get(mon.replace("val/", "val_"))
                if val is not None:
                    self.ckpt.update_best(name, mon, float(val), rt.config.monitor_mode,
                                          self.model, epoch)
                if (epoch + 1) % self.cfg.save_every_epochs == 0:
                    self.ckpt.save(self.model, self.state, epoch, name, metrics)
                self.logger.info("epoch %d | task %s | %s", epoch, name,
                                 {k: round(float(v), 5) for k, v in metrics.items()})
        for sink in self.wandb.values():
            sink.finish()
        return {"history": history, "state": self.state}
