"""``cli/train.py`` over a process group of gloo ranks on the CPU, and the
device-resident loader.

The ranks are spawned processes (``tests/torch_parallel_workers.py``) that
join a ``file://`` rendezvous in the test's temporary directory, one torch
thread each. The runs train face recognition alone (the tiny preset at
64^2, 4 train images a task from ``tools/make_dataset.py``, batch 2), so
that each writes one combined checkpoint and stays small on disk.
"""

import shutil
import threading

import numpy as np
import pytest
import torch

from prpe_tpu_torch.cli import train as cli
from prpe_tpu_torch.data import pipeline
from prpe_tpu_torch.parallel import mesh as pmesh
from prpe_tpu_torch.tools.make_dataset import make_dataset

import torch_parallel_workers as W
from torch_one_thread import torch_on_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    make_dataset(d, 4, 2, det_size=64, pose_size=64, face_size=32, identities=2,
                 per_identity=20)
    return d


def argv(data, run_dir, *extra):
    return ["--device", "cpu", "--preset", "tiny", "--image-size", "64", "--batch-size", "2",
            "--max-train-samples", "4", "--max-val-samples", "4",
            "--person-data-dir", str(data / "person"), "--face-data-dir", str(data / "face"),
            "--face-rec-data-dir", str(data / "faces"), "--pose-data-dir", str(data / "pose"),
            "--component-dir", str(run_dir / "none"), "--checkpoint-dir", str(run_dir / "ck"),
            "--log-dir", str(run_dir / "log"), *extra]


def checkpoint_shapes(ck_dir):
    out = {}
    for p in sorted(ck_dir.glob("*.pt")):
        payload = torch.load(p, map_location="cpu", weights_only=True)

        def shapes(tree):
            if isinstance(tree, torch.Tensor):
                return tuple(tree.shape)
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return [shapes(v) for v in tree]
            return type(tree).__name__
        out[p.name] = shapes(payload)
    return out


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """One epoch of face recognition at world 1 (no mesh), at world 2
    (dp = 2, epochs refreshed on the device), and a resume of the world-1
    run's checkpoint at (dp, mp) = (1, 2) for a second epoch."""
    root = tmp_path_factory.mktemp("runs")
    one = ["--tasks", "face_recognition", "--epochs", "1"]
    assert cli.main(argv(data, root / "w1", *one)) == 0
    assert W.spawn(W.cli_worker, 2, str(root / "init2"),
                   argv(data, root / "w2", *one, "--data-parallel", "2", "--device-resident",
                        "--device-resident-refresh")) == 0
    shutil.copytree(root / "w1" / "ck", root / "resume" / "ck")
    assert W.spawn(W.cli_worker, 2, str(root / "init3"),
                   argv(data, root / "resume", "--tasks", "face_recognition", "--epochs", "2",
                        "--data-parallel", "1", "--model-parallel", "2",
                        "--resume-checkpoint", "latest")) == 0
    out = {name: checkpoint_shapes(root / name / "ck") for name in ("w1", "w2", "resume")}
    out["history"] = {name: (root / name / "log" / "face_recognition_history.csv").read_text()
                      for name in ("w1", "w2", "resume")}
    yield out
    shutil.rmtree(root, ignore_errors=True)


def test_world2_writes_one_checkpoint_like_world1(runs):
    """Each save writes one file whatever the world: the primary rank's,
    with the full (E, C) face_kernel, equal in keys and shapes to a
    one-process run's."""
    assert sorted(runs["w1"]) == ["best_face_recognition.pt", "epoch0000_face_recognition.pt"]
    assert runs["w2"] == runs["w1"]
    assert runs["w1"]["epoch0000_face_recognition.pt"]["model"]["face_kernel"] == (512, 64)
    lines = runs["history"]["w2"].splitlines()
    assert len(lines) == 2 and "val/ver_acc" in lines[0]  # one header, one epoch, by rank 0


def test_resume_at_mp2_from_an_mp1_checkpoint(runs):
    """A checkpoint written without a mesh resumes at (1, 2): each rank
    takes its half of the classes, and the next save gathers them again."""
    got = runs["resume"]
    assert "epoch0001_face_recognition.pt" in got
    assert got["epoch0001_face_recognition.pt"] == runs["w1"]["epoch0000_face_recognition.pt"]
    head, row = runs["history"]["resume"].splitlines()[-2:]
    assert row.startswith("1,")  # the second epoch, after the resume
    assert all(np.isfinite(float(x)) for x in row.split(","))


def test_only_the_primary_rank_copies_a_checkpoint_to_the_host(tmp_path):
    """Every rank takes part in a save's gather; only the primary copies the
    tree to the host and writes it."""
    from prpe_tpu_torch.train.checkpoint import CheckpointManager

    tree = {"model": {"face_kernel": torch.arange(32.0).reshape(4, 8)}, "step": 3}
    other = pmesh.Mesh((2, 1))
    other.data_rank = 1
    assert CheckpointManager(tmp_path / "other", mesh=other)._full(tree) is None
    full = CheckpointManager(tmp_path / "primary", mesh=pmesh.Mesh((2, 1)))._full(tree)
    assert full["step"] == 3 and torch.equal(full["model"]["face_kernel"],
                                             tree["model"]["face_kernel"])


def test_batch_size_is_the_global_batch(data):
    """Under a (2, 2) mesh each data rank's loaders take batch / 2 rows
    from their data rank's stride of the samples: as many steps an epoch as
    one process, the two ranks of a model group the same rows, the two data
    ranks together the single process's batch (the val loaders, which do
    not augment)."""
    args = cli.parse_args(argv(data, data / "unused"))  # the global batch of 2
    cfg = cli.model_config(args)
    single = cli.build_task_loaders(args, cfg)
    ranked = {}
    for data_rank in range(2):
        for model_rank in range(2):
            mesh = pmesh.Mesh((2, 2))
            mesh.data_rank, mesh.model_rank = data_rank, model_rank
            ranked[(data_rank, model_rank)] = cli.build_task_loaders(args, cfg, mesh=mesh)

    def rows(loader, batch):
        got = [next(iter(b.values())) for b in loader.host(0)]
        assert got and all(len(x) == batch for x in got)
        return np.concatenate(got)

    try:
        for task in single:
            for split in ("train", "val"):
                if single[task].get(split) is None:
                    continue
                whole = rows(single[task][split], 2)
                got = {}
                for coords, loaders in ranked.items():
                    loader = loaders[task][split]
                    assert loader.steps_per_epoch == single[task][split].steps_per_epoch
                    assert loader.per_rank
                    got[coords] = rows(loader, 1)
                for data_rank in range(2):
                    np.testing.assert_array_equal(got[(data_rank, 0)], got[(data_rank, 1)])
                    if split == "val":  # data rank r reads every other sample from the r-th
                        np.testing.assert_array_equal(got[(data_rank, 0)],
                                                      whole[data_rank::2])
    finally:
        cli.close_loaders(single)
        for loaders in ranked.values():
            cli.close_loaders(loaders)


def test_a_mesh_without_a_rendezvous_runs_on_a_group_of_its_own(data, tmp_path):
    """``--data-parallel 1`` alone: a process group of this process, so the
    mesh's collectives run (at size 1); a mesh larger than the world is
    refused."""
    assert cli.main(argv(data, tmp_path / "ok", "--tasks", "pose_estimation", "--epochs", "1",
                         "--data-parallel", "1", "--save-every", "2")) == 0
    shutil.rmtree(tmp_path / "ok")  # its checkpoints
    with pytest.raises(ValueError, match="mesh 2x1 != 1"):
        cli.main(argv(data, tmp_path / "bad", "--data-parallel", "2"))


def test_refuses_a_batch_the_mesh_does_not_split(data, tmp_path):
    with pytest.raises(Exception, match="--batch-size 3 does not split over 2 data ranks"):
        W.spawn(W.cli_worker, 2, str(tmp_path / "init"),
                argv(data, tmp_path, "--batch-size", "3", "--data-parallel", "2"))


def test_a_failed_rendezvous_raises(data, tmp_path):
    """Where JAX carries on as one process, the port raises."""
    with pytest.raises(RuntimeError, match="rendezvous"):
        cli.main(argv(data, tmp_path, "--coordinator", "nowhere://x", "--num-processes", "2",
                      "--process-id", "0", "--data-parallel", "-1"))


# --------------------------------------------------- device-resident loader

class EpochLoader:
    """epoch -> 3 host batches whose values carry the epoch; ``gate[e]``
    holds epoch e back until set; ``fail_at`` raises in that epoch."""

    def __init__(self, fail_at=None):
        self.gate = {e: threading.Event() for e in range(5)}
        self.fail_at = fail_at
        self.closed = False
        self.steps_per_epoch = 3

    def __call__(self, epoch):
        self.gate[epoch].wait(30)
        if epoch == self.fail_at:
            raise ValueError(f"bad record in epoch {epoch}")
        for i in range(3):
            yield {"x": np.full((2, 4), 10 * epoch + i, np.float32),
                   "label": np.array([epoch, i])}

    def close(self):
        self.closed = True


def values(batches):
    return [int(b["x"][0, 0]) for b in batches]


def wait_host_epoch(loader, epoch):
    for _ in range(3000):
        if loader.stats["host_epoch"] == epoch:
            return
        threading.Event().wait(0.01)
    raise AssertionError(f"the host thread never readied epoch {epoch}")


def test_device_resident_frozen_replays_epoch0():
    src = EpochLoader()
    src.gate[0].set()
    dr = pipeline.device_resident_loader(src, device="cpu", reshuffle=True, seed=3)
    assert src.closed  # frozen: the source is done after staging
    assert values(dr(0)) == [0, 1, 2]
    e1, e2 = values(dr(1)), values(dr(2))
    assert sorted(e1) == sorted(e2) == [0, 1, 2] and (e1, e2) != ([0, 1, 2], [0, 1, 2])
    order = np.arange(3)
    np.random.default_rng(3 + 1).shuffle(order)
    assert e1 == order.tolist()
    assert dr.total_bytes == 3 * (2 * 4 * 4 + 2 * 8)
    assert dr.steps_per_epoch == 3 and not dr.per_rank
    assert (dr.stats["fresh_epochs"], dr.stats["stale_epochs"]) == (1, 0)
    assert isinstance(next(iter(dr(0)))["x"], torch.Tensor)
    sharded = pipeline.device_resident_loader(
        src, device="cpu", reshuffle=False, shard=lambda b: {k: v[1:] for k, v in b.items()})
    assert sharded.per_rank and next(iter(sharded(0)))["x"].shape == (1, 4)


def test_device_resident_refresh_counts_fresh_and_stale_epochs():
    src = EpochLoader()
    src.gate[0].set()
    dr = pipeline.device_resident_loader(src, device="cpu", reshuffle=False, refresh=True)
    assert dr.total_bytes == 2 * 3 * (2 * 4 * 4 + 2 * 8)  # room for two epochs
    assert values(dr(0)) == [0, 1, 2]
    # epoch 1's host batches are held back: the epoch replays epoch 0, stale
    assert values(dr(1)) == [0, 1, 2]
    assert (dr.stats["fresh_epochs"], dr.stats["stale_epochs"]) == (1, 1)
    src.gate[1].set()
    wait_host_epoch(dr, 1)
    # epoch 2 replays what is staged while epoch 1's batches go to the device
    assert values(dr(2)) == [0, 1, 2]
    # epoch 3 replays epoch 1's batches; epoch 2's are held back: stale
    assert values(dr(3)) == [10, 11, 12]
    assert (dr.stats["fresh_epochs"], dr.stats["stale_epochs"]) == (2, 2)
    dr.close()
    assert src.closed


def test_device_resident_refresh_raises_the_host_threads_error():
    src = EpochLoader(fail_at=1)
    src.gate[0].set()
    src.gate[1].set()
    dr = pipeline.device_resident_loader(src, device="cpu", refresh=True)
    wait_host_epoch(dr, 1)
    with pytest.raises(ValueError, match="bad record in epoch 1"):
        list(dr(1))
    dr.close()


def test_cli_refuses_to_stage_beyond_the_budget(data, tmp_path, capsys):
    with pytest.raises(SystemExit, match="--device-resident-max-gb"):
        cli.main(argv(data, tmp_path, "--device-resident", "--device-resident-max-gb", "1e-6"))
    assert not (tmp_path / "ck").exists()  # refused before the model was built
