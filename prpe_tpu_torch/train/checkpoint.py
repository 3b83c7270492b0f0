"""Checkpoints of the combined train state (``prpe_tpu/train/checkpoint.py``).

* A combined checkpoint after every (epoch, task): the model's state dict
  (parameters, BatchNorm and margin statistics), every task's optimizer
  state, the EMA and the counters, with ``epoch`` and ``last_task`` in
  ``meta.json``; the newest ``keep`` are kept.
* A slim ``best_<task>`` (the model's state dict only) whenever the task's
  monitor improves; ``save_model`` / ``load_model`` write and read that
  format anywhere (the YOLO trainer's ``last`` and ``best``).

Each file is written with ``torch.save`` to a temporary name in the same
directory and renamed over its slot with ``os.replace``, so a kill during a
save leaves either the old file or the new one, plus at most a ``*.tmp*``
leftover that the next save clears and ``latest`` / ``restore`` ignore.
``latest`` falls back from ``meta.json`` to what is on disk (newest
``epoch*`` first, then ``best_*``) when the meta file is torn or behind.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from prpe_tpu_torch.train.state import TrainState

_SUFFIX = ".pt"


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _to_device(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


def _atomic_write(path: Path, write) -> None:
    """``write(tmp_path)``, then rename over ``path``; stale leftovers of
    the same slot are removed first."""
    for p in path.parent.glob(path.name + ".tmp*"):
        p.unlink(missing_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    write(tmp)
    os.replace(tmp, path)


def save_model(path, state_dict: Dict[str, torch.Tensor]) -> str:
    """A slim checkpoint, ``{"model": state_dict}`` on the CPU (the format of
    ``best_*``), written to a temporary name and renamed over ``path``
    (``.pt`` added when it has no suffix)."""
    path = Path(path).absolute()
    if not path.suffix:
        path = path.with_name(path.name + _SUFFIX)
    path.parent.mkdir(parents=True, exist_ok=True)
    _atomic_write(path, lambda tmp: torch.save({"model": _to_cpu(state_dict)}, tmp))
    return str(path)


def load_model(path) -> Dict[str, torch.Tensor]:
    """The model state dict of a checkpoint file: a slim or combined
    checkpoint (its ``model``) or a bare state dict; ``path`` may omit
    ``.pt``."""
    path = Path(path)
    if not path.exists() and not path.suffix:
        path = path.with_name(path.name + _SUFFIX)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload["model"] if "model" in payload else payload


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._meta_path = self.dir / "meta.json"

    def _write(self, path: Path, write) -> None:
        _atomic_write(path, write)

    def _save_slot(self, name: str, payload) -> Path:
        path = self.dir / (name + _SUFFIX)
        self._write(path, lambda tmp: torch.save(payload, tmp))
        return path

    # ----------------------------------------------------------------- #
    def _meta(self) -> Dict[str, Any]:
        if self._meta_path.exists():
            try:
                return json.loads(self._meta_path.read_text())
            except json.JSONDecodeError:
                pass  # a torn meta file: the disk scan of latest() takes over
        return {"checkpoints": [], "best": {}}

    def _write_meta(self, meta) -> None:
        self._write(self._meta_path, lambda tmp: tmp.write_text(json.dumps(meta, indent=2)))

    # ----------------------------------------------------------------- #
    def save(self, model: nn.Module, state: TrainState, epoch: int, last_task: str,
             metrics: Optional[Dict[str, float]] = None) -> str:
        name = f"epoch{epoch:04d}_{last_task}"
        payload = {"model": _to_cpu(model.state_dict()), "step": state.step,
                   "opt_states": _to_cpu(state.opt_states),
                   "ema_params": _to_cpu(state.ema_params), "ema_updates": state.ema_updates}
        path = self._save_slot(name, payload)
        meta = self._meta()
        meta["checkpoints"].append(
            {"name": name, "epoch": epoch, "last_task": last_task,
             "metrics": {k: float(v) for k, v in (metrics or {}).items()}})
        while len(meta["checkpoints"]) > self.keep:  # keep the newest `keep`
            old = meta["checkpoints"].pop(0)
            best_names = {b["name"] for b in meta["best"].values()}
            if old["name"] not in best_names:
                (self.dir / (old["name"] + _SUFFIX)).unlink(missing_ok=True)
        self._write_meta(meta)
        return str(path)

    def update_best(self, task: str, monitor: str, value: float, mode: str, model: nn.Module,
                    epoch: int) -> bool:
        """Save ``best_<task>`` (the model's state dict only: for selection
        and deployment; resuming uses the combined checkpoints) when
        ``value`` beats the task's best under ``mode``. Returns whether it
        did."""
        meta = self._meta()
        best = meta["best"].get(task)
        better = (best is None or (mode == "max" and value > best["value"])
                  or (mode == "min" and value < best["value"]))
        if better:
            name = f"best_{task}"
            self._save_slot(name, {"model": _to_cpu(model.state_dict())})
            meta["best"][task] = {"value": float(value), "monitor": monitor, "epoch": epoch,
                                  "name": name, "slim": True}
            self._write_meta(meta)
        return better

    # ----------------------------------------------------------------- #
    def _committed(self, pattern: str):
        """Checkpoint files on disk that finished their rename."""
        return sorted(p for p in self.dir.glob(pattern + _SUFFIX) if p.is_file())

    def latest(self) -> Optional[Tuple[str, Dict[str, Any]]]:
        """The newest checkpoint: ``meta.json``'s last entry when its file
        exists, else the newest ``epoch*`` file, else the newest ``best_*``."""
        meta = self._meta()
        if meta["checkpoints"]:
            entry = meta["checkpoints"][-1]
            path = self.dir / (entry["name"] + _SUFFIX)
            if path.is_file():
                return str(path), entry
        epochs = self._committed("epoch*")
        if epochs:
            p = epochs[-1]  # epoch%04d_<task>: sorted by name is sorted by epoch
            num, _, task = p.stem[len("epoch"):].partition("_")
            return str(p), {"name": p.stem, "epoch": int(num), "last_task": task}
        bests = self._committed("best_*")
        if bests:
            by_name = {b["name"]: dict(b, last_task=t) for t, b in meta["best"].items()}
            p = sorted(bests, key=lambda q: by_name.get(q.stem, {}).get("epoch", -1))[-1]
            return str(p), by_name.get(p.stem, {"name": p.stem})
        return None

    def restore(self, model: nn.Module, state: TrainState,
                path: Optional[str] = None) -> Tuple[TrainState, Dict[str, Any]]:
        """Load a checkpoint into ``model`` and a new ``TrainState`` (``latest``
        when ``path`` is None; a bare name resolves in this directory). A slim
        ``best_*`` checkpoint keeps ``state`` as it is (fresh optimizers).
        Returns the state and the checkpoint's meta entry (epoch, last task)."""
        if path is None:
            found = self.latest()
            if found is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
            path, entry = found
        else:
            p = Path(path)
            if not p.is_absolute() and not p.exists():
                p = self.dir / p
            if not p.exists() and p.suffix != _SUFFIX:
                p = p.with_name(p.name + _SUFFIX)
            meta = self._meta()
            stem = p.name[:-len(_SUFFIX)] if p.name.endswith(_SUFFIX) else p.name
            entry = next((e for e in meta["checkpoints"] if e["name"] == stem), None)
            if entry is None:
                entry = next(({"name": b["name"], "epoch": b["epoch"], "last_task": task}
                              for task, b in meta["best"].items() if b["name"] == stem), {})
            path = p
        device = next(model.parameters()).device
        payload = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(payload["model"])
        if "opt_states" not in payload:  # slim best_* checkpoint
            return state, entry
        restored = TrainState(step=payload["step"],
                              opt_states=_to_device(payload["opt_states"], device),
                              ema_params=_to_device(payload["ema_params"], device),
                              ema_updates=payload["ema_updates"])
        return restored, entry
