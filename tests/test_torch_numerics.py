"""The port's numerics harness (``prpe_tpu_torch/tools/scenes.py``,
``check_cascade_numerics.py``, ``make_numerics_pose_ckpt.py``) against the
JAX-side scripts on the CPU.

- The synthetic inputs are bit-identical to ``bench_io._make_scene``, the
  skeleton-scene closure of ``tools/check_cascade_numerics.py`` (compiled
  here from that file's source) and ``tools/make_numerics_pose_ckpt.py
  ::make_crop_batch`` on three seeds.
- ``runs/torch_numerics/detector_ckpt.npz`` is the orbax checkpoint
  ``runs/r4_numerics/detector_ckpt/`` bit for bit (``write_detector_npz``
  wrote it), and loads into the port's YOLOv11-n.
- The IoU matrix and greedy matcher equal the JAX tool's exactly.
- The bf16 check runs end to end at a tiny geometry: its report has every
  key of ``runs/r3_numerics/cascade_fp32_vs_bf16.json``, and fp32 held
  against fp32 flips nothing and drifts by 0.
- The pose tool's pck and schedule equal the JAX script's, and its
  drawing process hands over the JAX script's batches in order.
"""

import ast
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prpe_tpu.nn.yolo import YOLO as JYOLO
from prpe_tpu.ops.heatmap import decode_heatmaps as jdecode_heatmaps
from prpe_tpu.ops.losses import pck_accuracy as jpck_accuracy
from prpe_tpu_torch.core.config import PoseConfig
from prpe_tpu_torch.models.porting import from_jax_variables, variables_from_npz
from prpe_tpu_torch.nn.common import build_on
from prpe_tpu_torch.nn.yolo import YOLO
from prpe_tpu_torch.tools import check_cascade_numerics as pcheck
from prpe_tpu_torch.tools import make_numerics_pose_ckpt as ppose
from prpe_tpu_torch.tools import scenes
from torch_one_thread import torch_on_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
DETECTOR_CKPT = ROOT / "runs" / "r4_numerics" / "detector_ckpt"
DETECTOR_NPZ = ROOT / "runs" / "torch_numerics" / "detector_ckpt.npz"
JAX_REPORT = ROOT / "runs" / "r3_numerics" / "cascade_fp32_vs_bf16.json"
TINY_POSE = PoseConfig(input_size=(32, 32), heatmap_size=(8, 8), vit_hidden=16, vit_layers=1,
                       vit_heads=2)

for _p in (ROOT, ROOT / "tools"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def restore_detector(ckpt=DETECTOR_CKPT):
    """The trained YOLOv11-n variables of an orbax checkpoint (numpy leaves)."""
    import orbax.checkpoint as ocp

    jm = JYOLO(nc=1, variant="n")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 128, 128, 3))))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return ocp.StandardCheckpointer().restore(pathlib.Path(ckpt).absolute(), dict(template))


def flatten_variables(tree, prefix=()):
    """{"/"-joined path: fp32 array} of a nested variable tree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flatten_variables(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = np.asarray(v, np.float32)
    return out


def write_detector_npz(out=DETECTOR_NPZ, ckpt=DETECTOR_CKPT):
    """Carries the orbax detector across once: its ``params`` and
    ``batch_stats`` flattened into ``out`` (about 10 MB), which the card
    reads without orbax."""
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **flatten_variables(restore_detector(ckpt)))


# ------------------------------------------------------------------ scenes

def jax_skeleton_scene():
    """The closure ``_make_scene`` inside ``check_bf16`` of the JAX tool,
    compiled from its source with the colours and skeleton it closes over."""
    from make_synthetic_multitask_data import _KP_COLORS, _SKELETON

    path = ROOT / "tools" / "check_cascade_numerics.py"
    check = next(n for n in ast.parse(path.read_text()).body
                 if isinstance(n, ast.FunctionDef) and n.name == "check_bf16")
    fn = next(n for n in check.body if isinstance(n, ast.FunctionDef) and n.name == "_make_scene")
    ns = {"np": np, "_KP_COLORS": _KP_COLORS, "_SKELETON": _SKELETON}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["_make_scene"]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_scenes_bit_identical_to_the_jax_generators(seed):
    from bench_io import _make_scene
    from make_numerics_pose_ckpt import make_crop_batch

    for size in (320, 640):
        np.testing.assert_array_equal(scenes.make_scene(np.random.default_rng(seed), size),
                                      _make_scene(np.random.default_rng(seed), size))
    want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    skeleton = jax_skeleton_scene()
    for _ in range(3):  # consecutive draws stay in step
        np.testing.assert_array_equal(scenes.make_skeleton_scene(got_rng, 640),
                                      skeleton(want_rng, 640))
    got = scenes.make_crop_batch(np.random.default_rng(seed), 4)
    want = make_crop_batch(np.random.default_rng(seed), 4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------- the detector npz

def test_detector_npz_is_the_orbax_checkpoint_bit_for_bit():
    pytest.importorskip("orbax.checkpoint")
    want = flatten_variables(restore_detector())
    with np.load(DETECTOR_NPZ) as got:
        assert sorted(got.files) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert 9e6 < DETECTOR_NPZ.stat().st_size < 12e6


def test_variables_from_npz_loads_into_the_port_yolo():
    """``variables_from_npz`` -> ``from_jax_variables`` gives the state dict
    of the orbax tree (the one ``tests/test_torch_nms.py`` loads), strictly
    loadable into ``YOLO(nc=1, variant="n")``."""
    pytest.importorskip("orbax.checkpoint")
    tree = variables_from_npz(DETECTOR_NPZ)
    assert set(tree) == {"params", "batch_stats"}
    got = from_jax_variables(tree)
    want = from_jax_variables(restore_detector())
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    model = build_on(torch.device("cpu"), lambda: YOLO(nc=1, variant="n"))
    model.load_state_dict(got, strict=True)


# ------------------------------------------------------------- the matcher

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_matrix_and_greedy_match_equal_the_jax_tool(seed):
    import check_cascade_numerics as jcheck

    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 200, (12, 2))
    a = np.concatenate([a, a + rng.uniform(5, 60, (12, 2))], -1).astype(np.float32)
    b = a[rng.permutation(12)[:9]] + rng.normal(0, 4, (9, 4)).astype(np.float32)
    np.testing.assert_array_equal(pcheck._iou_matrix(a, b), jcheck._iou_matrix(a, b))
    for thr in (0.6, 0.3):
        assert pcheck._greedy_match(a, b, thr) == jcheck._greedy_match(a, b, thr)
    assert pcheck._greedy_match(a, b) != []
    assert pcheck._greedy_match(a[:0], b) == jcheck._greedy_match(a[:0], b) == []


# ---------------------------------------------------------- the bf16 check

@pytest.mark.parametrize("low", ["float32", "bfloat16"])
def test_check_bf16_end_to_end_at_a_tiny_geometry(tmp_path, low):
    """Scenes of 256^2 (4 in batches of 2), the trained detector in both
    slots, IR-18 and a 1-block ViT from seed 0. fp32 against fp32: every
    comparison exact. bf16: the same keys and counts in range."""
    out = tmp_path / "report.json"
    report = pcheck.check_bf16(4, 2, DETECTOR_NPZ, DETECTOR_NPZ, None, 4, out=out, device="cpu",
                               scene_size=256, pose_cfg=TINY_POSE, irnet_layers=18,
                               low_dtype=getattr(torch, low))
    assert json.loads(out.read_text()) == report
    want_keys = set(json.loads(JAX_REPORT.read_text()))
    modes = pcheck.SAME_CROP_MODES
    per_mode = {f"{k}_{m}" for m in modes for k in (
        "pose_same_crop_pairs", "keypoint_drift_same_crop_maxabs_px640",
        "keypoint_drift_same_crop_p99_px640")}
    assert set(report) == want_keys | per_mode | {"weights"}
    assert report["criteria"] == json.loads(JAX_REPORT.read_text())["criteria"]
    assert report["weights"]["person_yolo"] == report["weights"]["face_yolo"] == str(DETECTOR_NPZ)
    assert report["person_detections_fp32"] > 0 and report["face_pairs_clear_margin"] > 0
    assert all(report[f"pose_same_crop_pairs_{m}"] == 4 for m in modes)
    assert report["pose_same_crop_pairs"] == 4
    if low == "float32":
        for k in ("gate_flips", "gate_flips_clear_margin", "identity_flips_clear_margin",
                  "non_tight_pairs"):
            assert report[k] == 0, k
        for k in ("matched_person_box_drift_maxabs_px", "face_similarity_drift_maxabs",
                  "keypoint_drift_maxabs_px640", "keypoint_drift_tight_maxabs_px640",
                  *(f"keypoint_drift_same_crop_maxabs_px640_{m}" for m in modes)):
            assert report[k] == 0.0, k
        for k in ("person_detection_match_rate", "face_detection_match_rate"):
            assert report[k] == 1.0, k
        assert report["pose_pairs_tight"] == report["pose_pairs"]
    else:
        assert all(np.isfinite(report[f"keypoint_drift_same_crop_maxabs_px640_{m}"])
                   for m in modes)
    assert not report["pass"]  # 4 same-crop pairs are under the 50 required


# ------------------------------------------------------------ the pose tool

def test_pose_ckpt_pck_equals_the_jax_score():
    """``crop_pck`` on fixed heatmaps equals the JAX script's
    ``pck_accuracy(decode_heatmaps(pred) * 256, kps * 256, vis, areas)``."""
    rng = np.random.default_rng(3)
    _, kps, areas = scenes.make_crop_batch(rng, 6)
    hm = rng.normal(0, 0.1, (6, 17, 64, 48)).astype(np.float32)
    # peaks at the targets for half the keypoints, elsewhere for the rest
    iy = np.clip((kps[:, 0, :, 1] * 64).astype(int), 0, 63)
    ix = np.clip((kps[:, 0, :, 0] * 48).astype(int), 0, 47)
    for i in range(6):
        for k in range(17):
            hm[i, k, iy[i, k] if k % 2 else 63 - iy[i, k], ix[i, k]] = 3.0
    coords, _ = jdecode_heatmaps(jnp.asarray(hm))
    want = float(jpck_accuracy(coords * 256, jnp.asarray(kps[:, 0, :, :2]) * 256,
                               jnp.asarray(kps[:, 0, :, 2]), jnp.asarray(areas[:, 0])))
    got = ppose.crop_pck(torch.from_numpy(hm), kps, areas)
    assert got == want
    assert 0.3 < got < 0.8


def test_pose_schedule_is_optax_warmup_cosine():
    sched = ppose.pose_schedule(1e-3, 400)
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup_steps=100, decay_steps=400)
    for count in (0, 1, 50, 99, 100, 101, 250, 399, 400, 450):
        assert np.float32(sched(count)) == np.float32(want(count)), count


def test_pose_crops_come_in_the_jax_scripts_order():
    """The drawing process's batches: the JAX script's training batches in
    order, then its 32 validation crops, from one ``default_rng(0)``."""
    import queue

    got = queue.Queue()
    ppose.draw_batches(got, 3, 2, 32, 24)
    rng = np.random.default_rng(0)
    for n in (2, 2, 2, 32):
        for g, w in zip(got.get_nowait(), scenes.make_crop_batch(rng, n, 32, 24), strict=True):
            np.testing.assert_array_equal(g, w)
    assert got.empty()


def test_make_numerics_pose_ckpt_trains_and_saves(tmp_path, capsys):
    """Three Adam steps of a 1-block ViT on 32x32 crops: a loadable state
    dict and a pck in [0, 1]."""
    out = tmp_path / "pose.pt"
    pck = ppose.train_pose_ckpt(3, 2, 1e-3, out, device="cpu", pose_cfg=TINY_POSE, warmup=1,
                                log_every=1)
    assert 0.0 <= pck <= 1.0
    assert "step 2: loss" in capsys.readouterr().out
    model = ppose.pose_model(TINY_POSE, torch.device("cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sd = torch.load(out, weights_only=True)
    model.load_state_dict(sd, strict=True)
    assert any(not torch.equal(before[k], sd[k]) for k in sd), "the weights moved"
