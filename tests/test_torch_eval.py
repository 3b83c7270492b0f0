"""The port's evaluation functions and eval hooks (``prpe_tpu_torch/eval/``)
against the JAX package's on the same inputs, on the CPU.

Both sides are the same numpy operations in the same order, so the
tolerance is equality: arrays equal element for element, metric dicts equal
key for key. The golden cases of ``tests/test_map_golden.py`` and
``tests/test_keypoint_eval.py`` run through both implementations and their
line-level reference transcriptions (at those files' own tolerances, 1e-12
and 1e-6). The hooks are fed from the tiny combined model's eval steps of
both packages on the same JAX tree and batches; the two sides' predictions
differ within ``tests/test_torch_eval_steps.py``'s tolerances (1e-4), and the
hooks' metrics are held within 1e-4 of their magnitude (at least 1), and
equal when both hooks read the same predictions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.eval import keypoint_eval as jkpt
from prpe_tpu.eval import map as jmap
from prpe_tpu.eval import pose_hook as jpose
from prpe_tpu.eval import verification as jver
from prpe_tpu.train import steps as jsteps
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.eval import keypoint_eval as pkpt
from prpe_tpu_torch.eval import map as pmap
from prpe_tpu_torch.eval import pose_hook as ppose
from prpe_tpu_torch.eval import verification as pver
from prpe_tpu_torch.ops.nms import Detections
from prpe_tpu_torch.train.steps import make_eval_step
from test_keypoint_eval import _scenario, cocoeval_reference
from test_map_golden import _scene, ref_compute_ap, ref_compute_metric
from test_torch_train import jax_variables, port_model, train_config
from torch_one_thread import torch_on_one_thread  # noqa: F401


def same(a, b):
    """Equal trees: dicts key for key, arrays element for element."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------ mAP ---

@pytest.mark.parametrize("seed", range(12))
def test_map_golden_scene_both_implementations(seed):
    images = _scene(seed)
    for det, scores, cls, gt, gt_cls in images:
        got = pmap.match_detections(det, cls, gt, gt_cls)
        same(got, jmap.match_detections(det, cls, gt, gt_cls))
        out6 = np.concatenate([det, scores[:, None], cls[:, None]], 1)
        tgt = np.concatenate([gt_cls[:, None], gt], 1)
        same(got, ref_compute_metric(out6, tgt, pmap.IOU_THRESHOLDS))
    got = pmap.evaluate_detections(images)
    same(got, jmap.evaluate_detections(images))
    tp = np.concatenate([pmap.match_detections(d, c, g, gc) for d, s, c, g, gc in images])
    gt_cls = np.concatenate([gc for *_, gc in images])
    if len(tp) and len(gt_cls):
        conf = np.concatenate([s for _, s, *_ in images])
        cls = np.concatenate([c for _, _, c, *_ in images])
        want = ref_compute_ap(tp, conf, cls, gt_cls)
        keys = ("precision", "recall", "f1", "mAP50", "mAP75", "mAP50-95")
        np.testing.assert_allclose([got[k] for k in keys], want, atol=1e-12)


def test_map_curves_smooth_and_iou_equal():
    rng = np.random.default_rng(0)
    images = _scene(3) + _scene(4)
    m, curves = pmap.evaluate_detections(images, return_curves=True)
    jm, jcurves = jmap.evaluate_detections(images, return_curves=True)
    same(m, jm)
    for f in ("classes", "conf_grid", "precision", "recall", "f1", "recall_grid",
              "pr_precision", "ap"):
        same(getattr(curves, f), getattr(jcurves, f))
    y = rng.random(1000)
    same(pmap.smooth(y, 0.05), jmap.smooth(y, 0.05))
    a, b = rng.uniform(0, 50, (7, 4)), rng.uniform(0, 50, (5, 4))
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    same(pmap.box_iou_matrix(a, b), jmap.box_iou_matrix(a, b))
    same(pmap.box_iou_matrix(a[:0], b), jmap.box_iou_matrix(a[:0], b))
    same(pmap.evaluate_detections([]), jmap.evaluate_detections([]))


def _detections(seed, b=3, k=12, size=64.0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.7, (b, k, 2))
    wh = rng.uniform(4, size * 0.3, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = -np.sort(-rng.random((b, k)), axis=1).astype(np.float32)
    valid = rng.random((b, k)) < 0.7
    gt = np.concatenate([rng.uniform(0.2, 0.8, (b, 5, 2)), rng.uniform(0.05, 0.3, (b, 5, 2))],
                        -1).astype(np.float32)
    batch = {"gt_boxes": gt, "gt_mask": rng.random((b, 5)) < 0.6,
             "gt_labels": np.zeros((b, 5), np.int32)}
    return (boxes, scores, np.zeros((b, k), np.int32), valid), batch


def test_detection_hook_takes_numpy_and_cpu_tensors():
    """``collect_per_image`` reads the port's ``Detections`` as numpy or as
    CPU tensors; both give the JAX hook's metrics."""
    outputs = []
    for seed in range(3):
        (boxes, scores, classes, valid), batch = _detections(seed)
        # plant matches: a few gt boxes as detections
        g = batch["gt_boxes"] * 64.0
        boxes[:, :5] = np.concatenate([g[..., :2] - g[..., 2:] / 2, g[..., :2] + g[..., 2:] / 2], -1)
        outputs.append(((boxes, scores, classes, valid), batch))
    as_np = [(Detections(*d), b) for d, b in outputs]
    as_torch = [(Detections(*(torch.from_numpy(a) for a in d)),
                 {k: torch.from_numpy(v) for k, v in b.items()}) for d, b in outputs]
    want = jmap.detection_eval_hook(64)([(Detections(*d), b) for d, b in outputs])
    assert want["mAP50"] > 0
    same(pmap.detection_eval_hook(64)(as_np), want)
    same(pmap.detection_eval_hook(64)(as_torch), want)
    same(pmap.collect_per_image(as_torch, 64), jmap.collect_per_image(as_np, 64))


# ------------------------------------------------------------ keypoints ---

@pytest.mark.parametrize("seed", range(12))
def test_keypoint_golden_scenario_both_implementations(seed):
    preds, anns = _scenario(seed)
    got = pkpt.evaluate_keypoints(preds, anns)
    same(got, jkpt.evaluate_keypoints(preds, anns))
    for key, w in cocoeval_reference(preds, anns).items():
        assert abs(got[key] - w) < 1e-6, (key, got[key], w)


def test_keypoint_oks_and_interp_equal():
    rng = np.random.default_rng(1)
    g = np.concatenate([rng.uniform(0, 100, (17, 2)), rng.integers(0, 3, (17, 1))], 1)
    p = np.concatenate([g[:, :2] + rng.normal(0, 3, (17, 2)), np.ones((17, 1))], 1)
    for gt in (g, np.concatenate([g[:, :2], np.zeros((17, 1))], 1)):
        for bbox in (None, [10.0, 10.0, 60.0, 80.0]):
            assert pkpt.compute_oks(p, gt, 900.0, bbox) == jkpt.compute_oks(p, gt, 900.0, bbox)
    rec = np.sort(rng.random(30))
    prec = rng.random(30)
    assert pkpt._interp_ap(rec, prec) == jkpt._interp_ap(rec, prec)
    thr = np.linspace(0.5, 0.9, 5)
    preds, anns = _scenario(7)
    same(pkpt.evaluate_keypoints(preds, anns, thr, 3),
         jkpt.evaluate_keypoints(preds, anns, thr, 3))


def test_pose_hook_perfect_and_shifted_predictions():
    """``tests/test_roi_eval.py``'s end-to-end case through both hooks:
    predictions equal to the ground truth score ~1, shifted ones ~0."""
    rng = np.random.default_rng(0)
    k, b = 17, 3
    coords = rng.uniform(0.2, 0.8, (b, k, 2)).astype(np.float32)
    scores = np.full((b, k), 0.9, np.float32)
    kpts = np.concatenate([coords[:, None], np.full((b, 1, k, 1), 2.0, np.float32)], axis=-1)
    batch = {"image_id": np.array([0, 1, 1]), "scale": np.full(b, 0.5, np.float32),
             "pad": np.tile(np.array([[16.0, 0.0]], np.float32), (b, 1)),
             "boxes": np.tile(np.array([[[64, 64, 576, 576]]], np.float32), (b, 1, 1)),
             "keypoints": kpts, "areas": np.full((b, 1), 512.0 * 512.0, np.float32),
             "mask": np.ones((b, 1), bool)}
    for shift, check in ((0.0, lambda m: m["kpt_AP"] > 0.99), (0.4, lambda m: m["kpt_AP"] < 0.05)):
        outputs = [((coords + shift, scores), batch)]
        got = ppose.pose_eval_hook(640)(outputs)
        same(got, jpose.pose_eval_hook(640)(outputs))
        assert check(got)
    # no image_id, scale or pad: defaults, as in JAX
    plain = {k: v for k, v in batch.items() if k not in ("image_id", "scale", "pad")}
    same(ppose.pose_eval_hook(64, 0.5)([((coords, scores * 0.5), plain)]),
         jpose.pose_eval_hook(64, 0.5)([((coords, scores * 0.5), plain)]))
    assert ppose.pose_eval_hook(64)([]) == {}


# --------------------------------------------------------- verification ---

@pytest.mark.parametrize("seed", range(4))
def test_verification_functions_equal(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3 + 4 * seed, 40 + 10 * seed)
    for max_pairs in (2000, 10):
        same(pver.make_pairs(labels, seed=seed, max_pairs=max_pairs),
             jver.make_pairs(labels, seed=seed, max_pairs=max_pairs))
    ia, ib, s = pver.make_pairs(labels, seed=seed)
    emb = rng.normal(size=(len(labels), 16)) + np.eye(16)[labels % 16] * 3
    same(pver.cosine_similarity(emb[ia], emb[ib]), jver.cosine_similarity(emb[ia], emb[ib]))
    for folds in (10, 3, 1000):
        same(pver.verification_accuracy(emb[ia], emb[ib], s, folds),
             jver.verification_accuracy(emb[ia], emb[ib], s, folds))
    scores = rng.uniform(-1, 1, 50)
    same_flags = rng.random(50) < 0.5
    thr = np.linspace(-1, 1, 21)
    assert pver.best_threshold_accuracy(scores, same_flags, thr) == \
        jver.best_threshold_accuracy(scores, same_flags, thr)
    logits = rng.normal(size=(30, 5))
    lab = rng.integers(0, 5, 30)
    assert pver.top1_accuracy(logits, lab) == jver.top1_accuracy(logits, lab)
    outputs = [(emb[i: i + 8], {"label": labels[i: i + 8]}) for i in range(0, len(labels), 8)]
    same(pver.face_verification_hook(seed=seed)(outputs),
         jver.face_verification_hook(seed=seed)(outputs))


def test_verification_hook_degenerate_inputs():
    emb = np.eye(4)
    for outputs in ([], [(None, {"label": np.arange(4)})], [(emb, {"label": np.arange(4)})],
                    [(emb, {"label": np.zeros(4, int)})]):
        assert pver.face_verification_hook()(outputs) == jver.face_verification_hook()(outputs)


# ------------------------------------------- hooks fed from the eval steps ---

HOOK_TASKS = ("person_detection", "face_recognition", "pose_estimation")


def hook_batches():
    """Batches for the three hooks at the tiny configuration's sizes: two
    detection batches of 2 at 64^2 with planted boxes, two face batches of 8
    over 3 identities (so the verification hook finds same-identity pairs),
    two pose batches of 2 with their letterbox metadata."""
    from prpe_tpu_torch.data import synthetic

    rng = np.random.default_rng(5)
    out = {t: [] for t in HOOK_TASKS}
    for i in range(2):
        out["person_detection"].append(synthetic.detection_batch(rng, 2, 64, 4))
        face = synthetic.face_batch(rng, 8, 64, 3)
        out["face_recognition"].append(face)
        pose = synthetic.pose_batch(rng, 2, 64, 3)
        pose.update(image_id=np.array([2 * i, 2 * i + 1]), scale=np.full(2, 0.5, np.float32),
                    pad=np.tile(np.array([[8.0, 0.0]], np.float32), (2, 1)))
        out["pose_estimation"].append(pose)
    return out


@pytest.fixture(scope="module")
def eval_outputs():
    """Per task, the (predictions, batch) pairs of the JAX eval step and of
    the port's, from the same variables and batches."""
    jm, v = jax_variables()
    cfg = train_config(jcfg)
    variables = jax.tree_util.tree_map(jnp.asarray, v)
    pm = port_model(v)
    batches = hook_batches()
    out = {}
    for task in HOOK_TASKS:
        jstep = jsteps.make_eval_step(jm, task, cfg)
        pstep = make_eval_step(pm, task, train_config(pcfg))
        jo, po = [], []
        for b in batches[task]:
            _, jp = jstep(variables, {k: jnp.asarray(a) for k, a in b.items()})
            jo.append((jax.device_get(jp), b))
            _, pp = pstep(b)
            po.append((jax.tree_util.tree_map(lambda t: t.numpy(), pp), b))
        out[task] = (jo, po)
    return out


def _hooks():
    return {"person_detection": (jmap.detection_eval_hook(64), pmap.detection_eval_hook(64)),
            "face_recognition": (jver.face_verification_hook(), pver.face_verification_hook()),
            "pose_estimation": (jpose.pose_eval_hook(64), ppose.pose_eval_hook(64))}


@pytest.mark.parametrize("task", HOOK_TASKS)
def test_hooks_from_eval_steps(eval_outputs, task):
    jo, po = eval_outputs[task]
    jhook, phook = _hooks()[task]
    want = jhook(jo)
    assert want, f"{task}: the JAX hook returned no metric"
    # the same predictions: equal
    same(phook(jo), want)
    # each package's own predictions: within 1e-4 of the metric's magnitude
    got = phook(po)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-4 * max(1.0, abs(w)), (k, got[k], w)
