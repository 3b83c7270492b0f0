"""The port's training CLI from datasets on disk, on the CPU.

One directory in the four layouts, written by the port's
``tools/make_dataset.py`` (detection and pose at 64^2, face crops at 32^2).
``build_task_loaders`` of the JAX package's CLI and of the port's, from the
same arguments, give equal first batches of every loader, bit for bit
(train loaders shuffled, capped and flipped with the same seeds), and put
the eval hooks and val loaders in the same places, with and without the
datasets. The port's ``main`` at the tiny preset then trains one epoch from
the directory with two decode workers and logs ``val/mAP50-95`` for both
detection tasks, ``val/ver_acc`` and ``val/kpt_AP``, and writes every
task's ``best_*`` checkpoint. The trainer hands its hooks host copies of
batches that lie on the device.
"""

import csv
import dataclasses
import math

import numpy as np
import pytest

from prpe_tpu.cli import train as jcli
from prpe_tpu.core import config as jcfg
from prpe_tpu_torch.cli import train as pcli
from prpe_tpu_torch.tools.make_dataset import make_dataset
from torch_one_thread import torch_on_one_thread  # noqa: F401

TASKS = ("person_detection", "face_detection", "face_recognition", "pose_estimation")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    # two identities of 20 crops: the 10 % val split holds a same-identity
    # pair, so the verification hook reports
    return make_dataset(tmp_path_factory.mktemp("data"), 8, 4, det_size=64, pose_size=64,
                        face_size=32, identities=2, per_identity=20)


def cli_args(root, tmp_path, *extra):
    return ["--device", "cpu", "--preset", "tiny", "--image-size", "64", "--batch-size", "2",
            "--person-data-dir", str(root / "person"), "--face-data-dir", str(root / "face"),
            "--face-rec-data-dir", str(root / "faces"), "--pose-data-dir", str(root / "pose"),
            "--max-train-samples", "4", "--max-val-samples", "4",
            "--checkpoint-dir", str(tmp_path / "ck"), "--log-dir", str(tmp_path / "log"), *extra]


def jax_tiny_config(args):
    """The JAX CLI's tiny preset (``prpe_tpu/cli/train.py:215-232``)."""
    return jcfg.CombinedModelConfig(
        image_size=args.image_size, backbone_stages=(1, 1, 1, 1),
        detection=jcfg.DetectionConfig(adapter_size=(args.image_size // 2,) * 2, max_gt=4),
        face=jcfg.AdaFaceConfig(arch="ir_18", num_classes=64),
        pose=dataclasses.replace(
            jcfg.PoseConfig(input_size=(32, 32), heatmap_size=(8, 8), vit_hidden=32,
                            vit_layers=1, vit_heads=2),
            sigma=args.pose_sigma, keypoint_thresh=args.keypoint_thresh))


def both_loaders(args):
    port = pcli.build_task_loaders(args, pcli.model_config(args))
    jax_side = jcli.build_task_loaders(args, jax_tiny_config(args))
    return port, jax_side


def first(loader, epoch=0):
    it = iter(loader(epoch))
    batch = {k: np.array(v) for k, v in next(it).items()}
    if hasattr(it, "close"):
        it.close()
    return batch


@pytest.mark.parametrize("with_data", [True, False])
def test_build_task_loaders_of_both_clis_agree(data_root, tmp_path, with_data):
    root = data_root if with_data else tmp_path / "missing"
    args = pcli.parse_args(cli_args(root, tmp_path))
    port, jax_side = both_loaders(args)
    try:
        assert port.keys() == jax_side.keys() == set(TASKS)
        for task in TASKS:
            assert port[task].keys() == jax_side[task].keys(), task
            assert hasattr(port[task]["train"], "host") == with_data, task
            for split in ("train", "val"):
                if split not in port[task]:
                    continue
                # the JAX host batches: its prefetch's device_put makes int64 int32
                jl = jax_side[task][split]
                got, want = first(port[task][split]), first(getattr(jl, "host", jl))
                assert got.keys() == want.keys(), (task, split)
                for k in want:
                    assert got[k].dtype == want[k].dtype, (task, split, k)
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{task} {split} {k}")
                if with_data:
                    assert (port[task][split].steps_per_epoch
                            == jax_side[task][split].steps_per_epoch)
        hooks = {t for t in TASKS if "eval_hook" in port[t]}
        assert hooks == (set(TASKS) if with_data else {"person_detection", "face_detection"})
        assert ("val" in port["pose_estimation"]) == with_data
    finally:
        pcli.close_loaders(port)
        jcli_close = [f for t in jax_side.values() for f in t.values() if hasattr(f, "close")]
        for f in jcli_close:
            f.close()


def test_cli_trains_from_disk_and_evaluates(data_root, tmp_path):
    # --save-every 2: no combined checkpoint (the tiny model is 191 MiB of
    # parameters); the best_* ones are written all the same
    assert pcli.main(cli_args(data_root, tmp_path, "--epochs", "1", "--num-workers", "2",
                              "--save-every", "2")) == 0
    want = {"person_detection": "val/mAP50-95", "face_detection": "val/mAP50-95",
            "face_recognition": "val/ver_acc", "pose_estimation": "val/kpt_AP"}
    for task, metric in want.items():
        with open(tmp_path / "log" / f"{task}_history.csv") as f:
            rows = list(csv.DictReader(f))
        assert len(rows) == 1 and metric in rows[0], (task, sorted(rows[0]))
        values = {k: float(v) for k, v in rows[0].items()}
        assert all(math.isfinite(v) for v in values.values()), (task, values)
        assert (tmp_path / "ck" / f"best_{task}.pt").exists(), task


def test_trainer_hands_the_hooks_host_copies_of_device_batches(tmp_path):
    """The prefetcher yields batches of tensors on the device; the trainer
    hands each hook numpy copies of them and of the predictions (a hook's
    ``np.asarray`` of a CUDA tensor raises)."""
    import torch

    from prpe_tpu_torch.eval.map import detection_eval_hook
    from test_torch_trainer import make_trainer

    trainer = make_trainer(tmp_path, ("person_detection",))
    rt = trainer.tasks["person_detection"]
    host_val = rt.val_loader
    rt.val_loader = lambda epoch: ({k: torch.as_tensor(v) for k, v in b.items()}
                                   for b in host_val(epoch))
    seen = []

    def hook(outputs):
        for det, batch in outputs:
            seen.extend(type(v) for v in (*det, *batch.values()))
        return detection_eval_hook(64)(outputs)

    rt.eval_hook = hook
    metrics = trainer.eval_task(0, "person_detection")
    assert seen and set(seen) == {np.ndarray}
    assert "val/mAP50-95" in metrics and math.isfinite(metrics["val/mAP50-95"])
