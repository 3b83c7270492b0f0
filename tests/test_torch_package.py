"""Package rules of the port: it imports neither JAX nor ``prpe_tpu``, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "prpe_tpu")
# absent on the card's host: imported only inside the functions that need them
# (transformers: bench_reference_torch's ViTPose-B, which names it when missing)
OPTIONAL = ("matplotlib", "PIL", "transformers")

_GUARDED_RUN = """
import importlib, pkgutil, sys
for name in {forbidden!r} + {optional!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import torch
torch.set_num_threads(1)  # the suite runs several test processes on the host's cores
import prpe_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(prpe_tpu_torch.__path__, "prpe_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import torch
from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
pose = PoseConfig(input_size=(32, 32), vit_hidden=16, vit_layers=1, vit_heads=2)
model = CascadeModel(DetectionConfig(pre_nms_top_k=16), pose, irnet_layers=18, device="cpu")
run = build_cascade_runner(model, CascadeConfig(max_persons=2, max_faces=2, conf_threshold=0.0),
                           pose_capacity=2, device="cpu")
res = run(torch.rand(1, 64, 64, 3), torch.zeros(2, 512))
assert res.pose_keypoints.shape == (2, 17, 2) and bool(torch.isfinite(res.pose_keypoints).all())
for m in {new_modules!r}:
    assert m in mods, m
from prpe_tpu_torch.core.config import AdaFaceConfig, CombinedModelConfig, TASKS
from prpe_tpu_torch.models.combined import CombinedModel
cfg = CombinedModelConfig(backbone_stages=(1, 1, 1, 1), detection=DetectionConfig(adapter_size=(32, 32)),
                          face=AdaFaceConfig(arch="ir_18", num_classes=4, input_size=(32, 32)), pose=pose)
combined = CombinedModel(cfg, device="cpu")
with torch.no_grad():
    for task in TASKS:
        combined(torch.rand(1, 64, 64, 3), task)
from prpe_tpu_torch.core.config import OptimConfig
from prpe_tpu_torch.data import synthetic
from prpe_tpu_torch.train.optim import build_optimizer
from prpe_tpu_torch.train.state import create_train_state
from prpe_tpu_torch.train.steps import make_train_step, trainable_params
import numpy as np
tx = build_optimizer(OptimConfig())
state = create_train_state(combined, {{"pose_estimation": tx}},
                           {{"pose_estimation": trainable_params(combined, "pose_estimation")}})
batch = synthetic.pose_batch(np.random.default_rng(0), 2, 64, 2)
import dataclasses
tcfg = dataclasses.replace(cfg, pose=dataclasses.replace(pose, heatmap_size=(8, 8)))
state, metrics = make_train_step(combined, "pose_estimation", tx, tcfg)(state, batch)
assert state.step == 1 and bool(torch.isfinite(metrics["loss"]))
import tempfile
from prpe_tpu_torch.data import pipeline
from prpe_tpu_torch.data.detection import YoloTxtDataset
from prpe_tpu_torch.data.faces import IdentityFolderDataset
from prpe_tpu_torch.data.pose import CocoKeypointDataset
from prpe_tpu_torch.eval.pose_hook import pose_eval_hook
from prpe_tpu_torch.tools.make_dataset import make_dataset
with tempfile.TemporaryDirectory() as d:
    make_dataset(d, 4, 2, det_size=32, pose_size=32, face_size=16, identities=2, per_identity=3)
    loader = pipeline.make_epoch_loader(YoloTxtDataset(d + "/person", "train", 24, 4), 2,
                                        num_workers=1)
    assert [b["image"].shape for b in loader(0)] == [(2, 24, 24, 3)] * 2
    loader.close()
    assert IdentityFolderDataset(d + "/faces", "train", 8)[0]["image"].shape == (8, 8, 3)
    pose = CocoKeypointDataset(d + "/pose", "val", image_size=24)
    batch = pipeline.default_collate([pose[0], pose[1]])
    hm = pose_eval_hook(24)([((batch["keypoints"][:, 0, :, :2], np.ones((2, 17))), batch)])
    assert hm["kpt_AP"] > 0.99, hm
from prpe_tpu_torch.data.detection import YoloMosaicDataset
from prpe_tpu_torch.eval.map import evaluate_detections
from prpe_tpu_torch.eval.plots import save_detection_curves
with tempfile.TemporaryDirectory() as d:
    make_dataset(d, 4, 2, det_size=32, pose_size=32, face_size=16, identities=2, per_identity=3)
    mosaic = YoloMosaicDataset(YoloTxtDataset(d + "/person", "train", 24, 4))
    loader = pipeline.make_epoch_loader(mosaic, 2, num_workers=1)
    assert [b["image"].shape for b in loader(0)] == [(2, 24, 24, 3)] * 2
    loader.close()
    box = np.array([[0.0, 0.0, 8.0, 8.0]], np.float32)
    _, curves = evaluate_detections([(box, np.ones(1, np.float32), np.zeros(1), box, np.zeros(1))],
                                    return_curves=True)
    try:
        save_detection_curves(curves, d + "/plots")
        raise AssertionError("plots without matplotlib")
    except ImportError as e:
        assert "matplotlib" in str(e) and "PR_curve.png" in str(e) and "R_curve.png" in str(e)
from prpe_tpu_torch.cli import train_yolo
with tempfile.TemporaryDirectory() as d:
    assert train_yolo.main(["--device", "cpu", "--synthetic", "--input-size", "32",
                            "--batch-size", "2", "--epochs", "1", "--output-dir", d]) == 0
from prpe_tpu_torch.cli import train as train_cli
from prpe_tpu_torch.core.dtypes import default_policy
from prpe_tpu_torch.data.pipeline import device_resident_loader
from prpe_tpu_torch.parallel import build_mesh, distributed, shard_batch
assert default_policy(True, "cpu").compute_dtype == torch.float32
mesh = build_mesh()
assert shard_batch({{"x": np.zeros((4, 2))}}, mesh)["x"].shape == (4, 2)
staged = device_resident_loader(lambda e: iter([{{"x": np.ones((2, 3), np.float32)}}]))
assert [b["x"].shape for b in staged(1)] == [(2, 3)]
with tempfile.TemporaryDirectory() as d:
    assert train_cli.main(["--device", "cpu", "--preset", "tiny", "--image-size", "64",
                           "--batch-size", "2", "--tasks", "pose_estimation", "--epochs", "1",
                           "--data-parallel", "1", "--person-data-dir", d + "/none",
                           "--face-data-dir", d + "/none", "--face-rec-data-dir", d + "/none",
                           "--pose-data-dir", d + "/none", "--component-dir", d + "/none",
                           "--checkpoint-dir", d + "/ck", "--log-dir", d + "/log"]) == 0
from prpe_tpu_torch.tools import bench_cascade
bench_cascade.main(["--dry-run"])
try:
    from prpe_tpu_torch.tools import bench_reference_torch
    bench_reference_torch.main(["--device", "cpu"])
    raise AssertionError("bench_reference_torch without transformers")
except SystemExit as e:
    assert "transformers" in str(e), e
print("imported", len(mods), "modules")
"""
# the modules of the combined model, the serving CLIs, the training path,
# the eval hooks, the data layer, the YOLO trainer, the dataset CLIs, the
# parallel slice, the numerics and convergence harness and the measuring tools
NEW_MODULES = ("prpe_tpu_torch.models.combined", "prpe_tpu_torch.nn.resnet",
               "prpe_tpu_torch.nn.adapters", "prpe_tpu_torch.ops.margin",
               "prpe_tpu_torch.data.image", "prpe_tpu_torch.cli.infer",
               "prpe_tpu_torch.cli.export", "prpe_tpu_torch.cli.build_model",
               "prpe_tpu_torch.ops.losses", "prpe_tpu_torch.ops.assigner",
               "prpe_tpu_torch.data.packed", "prpe_tpu_torch.data.synthetic",
               "prpe_tpu_torch.train.state", "prpe_tpu_torch.train.optim",
               "prpe_tpu_torch.train.steps", "prpe_tpu_torch.train.metrics",
               "prpe_tpu_torch.train.checkpoint", "prpe_tpu_torch.train.round_robin",
               "prpe_tpu_torch.cli.train",
               "prpe_tpu_torch.eval.map", "prpe_tpu_torch.eval.verification",
               "prpe_tpu_torch.eval.keypoint_eval", "prpe_tpu_torch.eval.pose_hook",
               "prpe_tpu_torch.native", "prpe_tpu_torch.data.detection",
               "prpe_tpu_torch.data.faces", "prpe_tpu_torch.data.pose",
               "prpe_tpu_torch.data.loader", "prpe_tpu_torch.data.pipeline",
               "prpe_tpu_torch.tools.make_dataset",
               "prpe_tpu_torch.data.augment", "prpe_tpu_torch.utils.profiling",
               "prpe_tpu_torch.eval.plots", "prpe_tpu_torch.cli.train_yolo",
               "prpe_tpu_torch.cli.convert_coco", "prpe_tpu_torch.cli.convert_ms1m",
               "prpe_tpu_torch.cli.eval_verification", "prpe_tpu_torch.cli.download_coco",
               "prpe_tpu_torch.cli.download_models",
               "prpe_tpu_torch.core.dtypes", "prpe_tpu_torch.parallel",
               "prpe_tpu_torch.parallel.distributed", "prpe_tpu_torch.parallel.mesh",
               "prpe_tpu_torch.parallel.collectives",
               "prpe_tpu_torch.tools.scenes", "prpe_tpu_torch.tools.make_numerics_pose_ckpt",
               "prpe_tpu_torch.tools.check_cascade_numerics",
               "prpe_tpu_torch.tools.run_convergence", "prpe_tpu_torch.tools.run_face_validation",
               "prpe_tpu_torch.tools.timing", "prpe_tpu_torch.tools.bench_cascade",
               "prpe_tpu_torch.tools.bench_train", "prpe_tpu_torch.tools.reference_nets",
               "prpe_tpu_torch.tools.bench_reference_torch", "prpe_tpu_torch.tools.bench_io",
               "prpe_tpu_torch.tools.profile_cascade", "prpe_tpu_torch.tools.profile_train",
               "prpe_tpu_torch.tools.dump_trace_ops", "prpe_tpu_torch.tools.bench_attention",
               "prpe_tpu_torch.tools.bench_vit_ln", "prpe_tpu_torch.tools.pose_gap")


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED_RUN.format(forbidden=FORBIDDEN, optional=OPTIONAL,
                                                   new_modules=NEW_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "imported" in proc.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "prpe_tpu_torch").rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_forbidden_import_statement(path):
    """Static check, for imports inside functions the guarded run never calls."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "prpe_tpu_torch").rglob("*.py")))
def test_no_unguarded_module_level_optional_import(path):
    """matplotlib and PIL are imported inside functions (or, for PIL, in a
    module-level ``try``), so every module imports on a host without them."""
    for node in ast.parse((ROOT / path).read_text()).body:
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in OPTIONAL, f"{path} imports {name} at module level"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU and without device='cpu' the entry points raise."""
    from prpe_tpu_torch.core.config import DetectionConfig, PoseConfig
    from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pose = PoseConfig(input_size=(32, 32), vit_hidden=16, vit_layers=1, vit_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CascadeModel(DetectionConfig(), pose, irnet_layers=18)
    model = CascadeModel(DetectionConfig(), pose, irnet_layers=18, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_cascade_runner(model)
    from prpe_tpu_torch.cli import build_model, export, infer
    from prpe_tpu_torch.models.combined import CombinedModel

    with pytest.raises(RuntimeError, match="device='cpu'"):
        CombinedModel()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.main(["frame.png", "--preset", "tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export.main(["--model", "vitpose", "--preset", "tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model.main(["--component-dir", "none"])
    from prpe_tpu_torch.cli import train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--preset", "tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--preset", "tiny", "--data-parallel", "1"])
    from prpe_tpu_torch.cli import eval_verification, train_yolo

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_yolo.main(["--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_verification.main(["pairs.npz"])


def test_harness_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The numerics and convergence tools raise without a GPU unless the
    caller asks for the CPU; none starts a trainer or writes data first."""
    from prpe_tpu_torch.tools import (
        check_cascade_numerics, make_numerics_pose_ckpt, run_convergence, run_face_validation,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = ["--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_numerics_pose_ckpt.main(["--steps", "1", *out])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_cascade_numerics.main(["bf16", "--scenes", "1", *out])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_convergence.main(["--data", str(tmp_path / "data"), *out])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_face_validation.main(["--data", str(tmp_path / "data"), *out])
    assert not any(tmp_path.iterdir())


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header changes every library's target, so
    the next build compiles it anew."""
    from prpe_tpu_torch.ops.kernels import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("k")
    assert _build._target("k") == before
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._target("k") != before


@pytest.mark.parametrize("lib", ["nms", "mhsa", "ln_mhsa"])
def test_every_entry_point_is_defined_in_its_source(lib):
    """Each C symbol the ctypes bindings declare is defined in its source."""
    from prpe_tpu_torch.ops.kernels import _build

    source = (_build.CSRC / f"{lib}.cu").read_text()
    for symbol in _build.SIGNATURES[lib]:
        assert f"int {symbol}(" in source or f"({symbol}," in source, symbol
