"""Port NMS (``prpe_tpu_torch.ops.nms`` and the plain version of the NMS
kernel) against the JAX package on the CPU. Keep masks must be equal."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops import nms as jnms
from prpe_tpu.ops.boxes import pairwise_iou as jpairwise_iou
from prpe_tpu.nn.yolo import YOLO as JYOLO, decode_predictions as jdecode
from prpe_tpu.ops.pallas.nms_kernel import pallas_greedy_nms
from prpe_tpu_torch.ops import nms as pnms
from prpe_tpu_torch.ops.boxes import pairwise_iou
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.nn.common import build_on
from prpe_tpu_torch.nn.yolo import YOLO, decode_predictions
from prpe_tpu_torch.ops.kernels.nms import nms_keep, nms_keep_plain

DETECTOR_CKPT = pathlib.Path(__file__).resolve().parents[1] / "runs" / "r4_numerics" / "detector_ckpt"


def clustered_boxes(rng, b, k):
    """Boxes around a few centres, so many pairs overlap past the threshold."""
    centers = rng.uniform(50, 550, size=(b, 8, 2))
    idx = rng.integers(0, 8, size=(b, k))
    cxy = np.take_along_axis(centers, idx[..., None], 1) + rng.normal(0, 8, (b, k, 2))
    wh = rng.uniform(20, 80, size=(b, k, 2))
    return np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("k", [64, 300])  # 300: not a multiple of the 256 row tile
def test_plain_keep_equals_pallas_and_greedy(k):
    rng = np.random.default_rng(k)
    b = 2
    boxes = clustered_boxes(rng, b, k)
    valid = rng.uniform(size=(b, k)) < 0.7  # not a prefix
    valid[:, -3:] = False  # the scan stops at the last valid index
    thr = 0.5

    got = nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), thr).numpy()
    assert got.dtype == np.bool_ and got.shape == (b, k)
    want = np.asarray(pallas_greedy_nms(jnp.asarray(boxes), jnp.asarray(valid),
                                        iou_threshold=thr, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()  # real suppression happened
    for i in range(b):
        jiou = jpairwise_iou(jnp.asarray(boxes[i]), jnp.asarray(boxes[i]))
        want_i = np.asarray(jnms.greedy_suppression_mask(jiou, jnp.asarray(valid[i]), thr))
        np.testing.assert_array_equal(got[i], want_i)
        piou = pairwise_iou(torch.from_numpy(boxes[i]), torch.from_numpy(boxes[i]))
        np.testing.assert_array_equal(
            pnms.greedy_suppression_mask(piou, torch.from_numpy(valid[i]), thr).numpy(), want_i)
        # the IoU itself agrees with the JAX package to the last bit
        np.testing.assert_array_equal(piou.numpy(), np.asarray(jiou))


def test_nms_keep_plain_is_the_cpu_path():
    rng = np.random.default_rng(1)
    boxes = torch.from_numpy(clustered_boxes(rng, 3, 40))
    valid = torch.from_numpy(rng.uniform(size=(3, 40)) < 0.8)
    assert torch.equal(nms_keep(boxes, valid, 0.65), nms_keep_plain(boxes, valid, 0.65))


@pytest.mark.parametrize("conf,max_det,top_k", [(0.0, 8, 64), (0.3, 100, 64)])
def test_non_max_suppression_matches_jax(conf, max_det, top_k):
    """Field by field against ``prpe_tpu.ops.nms.non_max_suppression``, both
    on the plain path; max_det 100 > K = 64 exercises the padding."""
    rng = np.random.default_rng(11)
    b, a = 2, 336  # the anchor count of a 128^2 image
    xyxy = clustered_boxes(rng, b, a)
    cxcywh = np.concatenate([(xyxy[..., :2] + xyxy[..., 2:]) / 2,
                             xyxy[..., 2:] - xyxy[..., :2]], -1)
    scores = rng.uniform(size=(b, a, 1)).astype(np.float32)
    scores[:, ::7] = 0.0  # ties below the threshold
    outputs = np.concatenate([cxcywh, scores], -1)
    kw = dict(conf_threshold=conf, iou_threshold=0.65, max_det=max_det, pre_nms_top_k=top_k)
    want = jnms.non_max_suppression(jnp.asarray(outputs), use_pallas=False, **kw)
    got = pnms.non_max_suppression(torch.from_numpy(outputs), **kw)
    for name in pnms.Detections._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.valid.any()


def test_topk_stable_breaks_ties_by_lower_index():
    x = torch.tensor([[1.0, float("-inf"), 3.0, float("-inf"), 3.0, float("-inf")]])
    values, idx = pnms.topk_stable(x, 5)
    assert idx.tolist() == [[2, 4, 0, 1, 3]]
    assert values[0, :3].tolist() == [3.0, 3.0, 1.0]


def test_trained_detector_detection_stage_matches_jax():
    """The detection stage (YOLOv11-n, decode, NMS) of both sides on the
    trained detector checkpoint and synthetic person scenes: trained scores
    are separated, so the kept sets are a real test of NMS, unlike random
    weights. Boxes within 1e-3 px, scores within 1e-5 (fp32 on both sides);
    the keep masks on the JAX candidates are equal to the Pallas kernel's."""
    ocp = pytest.importorskip("orbax.checkpoint")
    from bench_io import _make_scene

    jm = JYOLO(nc=1, variant="n")
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 128, 128, 3))))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = ocp.StandardCheckpointer().restore(DETECTOR_CKPT, dict(template))
    rng = np.random.default_rng(7)
    images = np.stack([_make_scene(rng, 320) for _ in range(2)]).astype(np.float32) / 255.0
    kw = dict(conf_threshold=0.25, iou_threshold=0.65, max_det=16, pre_nms_top_k=256)

    jout = jdecode(jax.jit(jm.apply)(variables, jnp.asarray(images)), 1, 16)
    want = jnms.non_max_suppression(jout, use_pallas=False, **kw)
    pm = build_on(torch.device("cpu"), lambda: YOLO(nc=1, variant="n"))
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = pnms.non_max_suppression(decode_predictions(pm(torch.from_numpy(images)), 1, 16), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 2 <= int(got.valid.sum()) < got.valid.numel(), "trained scores pass and fail the gate"
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)

    # the keep mask over the JAX top-256 candidates: plain version == Pallas
    scores = np.asarray(jout[..., 4])
    order = np.argsort(-scores, axis=1, kind="stable")[:, :256]
    boxes = np.take_along_axis(np.asarray(jout[..., :4]), order[..., None], 1)
    xyxy = np.concatenate([boxes[..., :2] - boxes[..., 2:] / 2, boxes[..., :2] + boxes[..., 2:] / 2], -1)
    valid = np.take_along_axis(scores, order, 1) > 0.01
    keep = nms_keep(torch.from_numpy(xyxy), torch.from_numpy(valid), 0.65).numpy()
    np.testing.assert_array_equal(keep, np.asarray(pallas_greedy_nms(
        jnp.asarray(xyxy), jnp.asarray(valid), iou_threshold=0.65, interpret=True)))
    assert 0 < keep.sum() < valid.sum()
