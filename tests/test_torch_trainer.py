"""The port's checkpoints, round-robin trainer and training CLI on the CPU,
at the tiny preset on synthetic batches (64^2 images, batch 2).

Checkpoints: save and restore, keep-N, the per-task best, the leftovers of
a torn save and a torn ``meta.json``. Trainer: the per-task steps in
order, the monitor fallbacks, EMA weights for evaluation, and a resume in
the middle of an epoch's cycle. CLI: ``main`` end to end, a resume from
its own checkpoint, and a directory without a dataset refused as one
(training from datasets on disk: ``tests/test_torch_train_data.py``).
"""

import json

import numpy as np
import pytest
import torch

from prpe_tpu_torch.cli import train as cli_train
from prpe_tpu_torch.core.config import OptimConfig, TaskConfig, TrainConfig
from prpe_tpu_torch.data import synthetic
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.train.checkpoint import CheckpointManager
from prpe_tpu_torch.train.optim import build_optimizer
from prpe_tpu_torch.train.round_robin import RoundRobinTrainer
from prpe_tpu_torch.train.state import create_train_state
from prpe_tpu_torch.train.steps import trainable_params
from torch_one_thread import torch_on_one_thread  # noqa: F401

SIZE = 64


def tiny_cfg():
    return cli_train.model_config(cli_train.parse_args(
        ["--preset", "tiny", "--image-size", str(SIZE)]))


def tiny_model(seed=0):
    return CombinedModel(tiny_cfg(), device="cpu", seed=seed)


def loaders(cfg, tasks, batches=1):
    kw = dict(batch_size=2, image_size=SIZE)
    out = {}
    for t in tasks:
        extra = ({"max_gt": cfg.detection.max_gt} if "detection" in t else
                 {"num_classes": cfg.face.num_classes} if t == "face_recognition" else
                 {"max_instances": cfg.pose.max_instances})
        out[t] = {"train": synthetic.make_loader(t, batches_per_epoch=batches, **kw, **extra),
                  "val": synthetic.make_loader(t, batches_per_epoch=1, seed=9, **kw, **extra)}
    return out


def state_for(model, tasks):
    txs = {t: build_optimizer(OptimConfig()) for t in tasks}
    return create_train_state(model, txs, {t: trainable_params(model, t) for t in tasks})


def same_tree(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


# ------------------------------------------------------------ checkpoints

def test_checkpoint_save_restore_keep_and_best(tmp_path):
    tasks = ("pose_estimation",)
    model = tiny_model()
    state = state_for(model, tasks)
    # one real update, so the optimizer state holds moments
    grads = {n: torch.ones_like(p) for n, p in trainable_params(model, tasks[0]).items()}
    _, state.opt_states[tasks[0]] = build_optimizer(OptimConfig()).update(
        grads, state.opt_states[tasks[0]], trainable_params(model, tasks[0]))
    state.step = 7
    ck = CheckpointManager(str(tmp_path), keep=2)
    for epoch in range(4):
        ck.save(model, state, epoch, tasks[0], {"train/loss": 1.0 / (epoch + 1)})
    names = sorted(p.name for p in tmp_path.glob("epoch*"))
    assert names == ["epoch0002_pose_estimation.pt", "epoch0003_pose_estimation.pt"]
    assert ck.update_best(tasks[0], "val_loss", 0.5, "min", model, 3)
    assert not ck.update_best(tasks[0], "val_loss", 0.7, "min", model, 3)
    assert ck.update_best(tasks[0], "val_loss", 0.4, "min", model, 3)
    assert json.loads((tmp_path / "meta.json").read_text())["best"][tasks[0]]["value"] == 0.4

    other = tiny_model(seed=1)
    fresh = state_for(other, tasks)
    restored, entry = CheckpointManager(str(tmp_path)).restore(other, fresh)
    assert entry["epoch"] == 3 and entry["last_task"] == tasks[0]
    assert restored.step == 7
    assert same_tree(restored.opt_states, state.opt_states)
    got = other.state_dict()
    for k, t in model.state_dict().items():
        assert torch.equal(got[k], t), k
    # a slim best_* checkpoint: the model only, the optimizers stay fresh
    restored, entry = CheckpointManager(str(tmp_path)).restore(other, fresh, "best_pose_estimation")
    assert restored is fresh and entry["last_task"] == tasks[0]


def test_checkpoint_ignores_leftovers_and_torn_meta(tmp_path):
    tasks = ("person_detection",)
    model = tiny_model()
    state = state_for(model, tasks)
    ck = CheckpointManager(str(tmp_path), keep=3)
    ck.save(model, state, 0, tasks[0])
    ck.save(model, state, 1, tasks[0])
    # a kill during the next save leaves a temporary file and a torn meta
    (tmp_path / "epoch0002_person_detection.pt.tmp999").write_bytes(b"partial")
    (tmp_path / "meta.json").write_text('{"checkpoints": [')
    path, entry = ck.latest()
    assert path.endswith("epoch0001_person_detection.pt")
    assert entry == {"name": "epoch0001_person_detection", "epoch": 1,
                     "last_task": "person_detection"}
    other = tiny_model(seed=2)
    ck.restore(other, state_for(other, tasks))
    # the next save of that slot clears the leftover
    ck.save(model, state, 2, tasks[0])
    assert not list(tmp_path.glob("*.tmp*"))
    assert ck.latest()[0].endswith("epoch0002_person_detection.pt")
    # nothing on disk: nothing to restore
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.latest() is None
    with pytest.raises(FileNotFoundError):
        empty.restore(model, state)


# ---------------------------------------------------------------- trainer

def make_trainer(tmp_path, tasks, epochs=1, use_ema=False, monitor=None):
    cfg = tiny_cfg()
    model = tiny_model()
    task_cfgs = tuple(TaskConfig(name=t, optim=OptimConfig(use_ema=use_ema, ema_tau=1.0),
                                 monitor=monitor or "val_loss") for t in tasks)
    tcfg = TrainConfig(total_epochs=epochs, checkpoint_dir=str(tmp_path / "ck"),
                       keep_checkpoints=10, tasks=task_cfgs)
    return RoundRobinTrainer(model, cfg, tcfg, loaders(cfg, tasks), log_dir=str(tmp_path / "log"))


def test_round_robin_trains_each_task_and_resumes_mid_cycle(tmp_path):
    tasks = ("person_detection", "pose_estimation")
    trainer = make_trainer(tmp_path, tasks)
    trunk = {k: t.clone() for k, t in trainer.model.state_dict().items()
             if k.startswith("backbone") and "running" not in k}
    out = trainer.train()
    assert [(h["epoch"], h["task"]) for h in out["history"]] == [(0, t) for t in tasks]
    for h in out["history"]:
        assert np.isfinite(h["train/loss"]) and np.isfinite(h["val_loss"])
        assert h["train/images_per_sec"] > 0
    # branch scope: the trunk's parameters did not move
    got = trainer.model.state_dict()
    for k, t in trunk.items():
        assert torch.equal(got[k], t), k
    ck = tmp_path / "ck"
    assert (ck / "epoch0000_person_detection.pt").exists()
    assert (ck / "best_pose_estimation.pt").exists()
    assert (tmp_path / "log" / "person_detection_history.csv").exists()
    assert "=== epoch 0 task pose_estimation" in (tmp_path / "log" / "training_metrics.log").read_text()

    # a run killed after the first task of epoch 0 continues with the second
    again = make_trainer(tmp_path, tasks, epochs=2)
    again.resume(str(ck / "epoch0000_person_detection.pt"))
    assert again.start_epoch == 0
    out = again.train()
    assert [(h["epoch"], h["task"]) for h in out["history"]] == [
        (0, "pose_estimation"), (1, "person_detection"), (1, "pose_estimation")]
    # after the last task of an epoch, the next epoch
    third = make_trainer(tmp_path, tasks, epochs=2)
    third.resume(None)  # latest: epoch 1, pose_estimation
    assert third.start_epoch == 2 and third.train()["history"] == []


def test_monitor_fallbacks_and_ema_eval(tmp_path):
    """An unset monitor saves no best; ``val/x`` finds ``val_x``; with EMA
    the eval runs on the EMA weights and the model's come back after."""
    trainer = make_trainer(tmp_path, ("face_detection",), monitor="val/mAP50-95")
    trainer.train()
    assert not list((tmp_path / "ck").glob("best_*"))

    trainer = make_trainer(tmp_path / "b", ("pose_estimation",), use_ema=True, monitor="val/loss")
    assert trainer.state.ema_params is not None
    trainer.train()
    assert (tmp_path / "b" / "ck" / "best_pose_estimation.pt").exists()
    assert trainer.state.ema_updates == 1
    params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    seen = {}

    def spy(batch):
        seen.update({n: p.detach().clone() for n, p in trainer.model.named_parameters()})
        return {"loss": torch.tensor(0.0)}, torch.zeros(1)

    trainer.tasks["pose_estimation"].eval_step = spy
    trainer.eval_task(0, "pose_estimation")
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, params[n])
        assert torch.equal(seen[n], trainer.state.ema_params[n])
    assert any(not torch.equal(seen[n], params[n]) for n in params)


# -------------------------------------------------------------------- CLI

def cli_args(tmp_path, *extra):
    missing = str(tmp_path / "missing")
    return ["--device", "cpu", "--preset", "tiny", "--image-size", str(SIZE), "--batch-size", "2",
            "--person-data-dir", missing, "--face-data-dir", missing, "--face-rec-data-dir",
            missing, "--pose-data-dir", missing, "--checkpoint-dir", str(tmp_path / "ck"),
            "--log-dir", str(tmp_path / "log"), *extra]


def test_cli_train_main_and_resume(tmp_path, capsys):
    tasks = "person_detection,pose_estimation"
    assert cli_train.main(cli_args(tmp_path, "--epochs", "1", "--tasks", tasks)) == 0
    ck = tmp_path / "ck"
    meta = json.loads((ck / "meta.json").read_text())
    assert [c["name"] for c in meta["checkpoints"]] == [
        "epoch0000_person_detection", "epoch0000_pose_estimation"]
    assert "using synthetic data" in capsys.readouterr().out
    assert cli_train.main(cli_args(tmp_path, "--epochs", "2", "--tasks", tasks,
                                   "--resume-checkpoint", "latest")) == 0
    meta = json.loads((ck / "meta.json").read_text())
    assert [c["epoch"] for c in meta["checkpoints"]][-2:] == [1, 1]
    history = (tmp_path / "log" / "pose_estimation_history.csv").read_text().splitlines()
    assert [row.split(",")[0] for row in history[1:]] == ["0", "1"]


def test_cli_refuses_a_dataset_and_unknown_tasks(tmp_path, capsys):
    """A directory that holds no dataset (no ``images/train``) is refused as
    one: the task falls back to synthetic batches, as in the JAX package.
    An unknown ``--tasks`` entry stops the CLI."""
    data = tmp_path / "coco_person"
    data.mkdir()
    args = cli_args(tmp_path, "--epochs", "1")
    args[args.index("--person-data-dir") + 1] = str(data)
    parsed = cli_train.parse_args(args)
    loaders = cli_train.build_task_loaders(parsed, cli_train.model_config(parsed))
    assert f"[person_detection] dataset not found at {data}; using synthetic data" in \
        capsys.readouterr().out
    person = loaders["person_detection"]
    assert person["train"].steps_per_epoch == 8 and not hasattr(person["train"], "host")
    assert "eval_hook" in person
    with pytest.raises(SystemExit, match="unknown task"):
        cli_train.main(cli_args(tmp_path, "--tasks", "segmentation"))
