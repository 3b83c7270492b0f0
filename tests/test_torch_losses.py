"""The port's training losses, box geometry, TAL assigner and heatmap
targets against the JAX package on the CPU, in fp32, from the same numpy
inputs; the detection loss also against the numpy transcription of the
reference (``tests/ref_yolo.py``).

Tolerances: values within 1e-5 of their magnitude (at least 1) unless a
test says otherwise; gradients within 1e-4 of the largest JAX gradient;
the assigner's masks exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops import assigner as jassigner
from prpe_tpu.ops import boxes as jboxes
from prpe_tpu.ops import heatmap as jheatmap
from prpe_tpu.ops import losses as jlosses
from prpe_tpu_torch.ops import assigner, boxes, heatmap, losses
from tests.ref_yolo import naive_assign, ref_compute_loss
from torch_one_thread import torch_on_one_thread  # noqa: F401

NC, REG_MAX = 3, 16
STRIDES = (8, 16)
LEVEL_HW = ((8, 8), (4, 4))


def t(a):
    return torch.from_numpy(np.asarray(a))


def close(got, want, tol=1e-5):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(1.0, float(np.abs(want).max()) if want.size else 1.0), err


def rand_xyxy(rng, shape, scale=64.0):
    xy = rng.uniform(0, scale * 0.7, shape + (2,))
    wh = rng.uniform(1.0, scale * 0.5, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_ciou_matches_jax_with_gradient():
    rng = np.random.default_rng(0)
    b1, b2 = rand_xyxy(rng, (64,)), rand_xyxy(rng, (64,))
    b2[:8] = b1[:8]  # identical pairs
    b2[8:16, :2] = b1[8:16, 2:] + 5.0  # disjoint pairs: the intersection clamps
    want = jboxes.ciou(jnp.asarray(b1), jnp.asarray(b2))
    x1 = t(b1).requires_grad_()
    got = boxes.ciou(x1, t(b2))
    close(got, want)
    (g,) = torch.autograd.grad(got.sum(), x1)
    jg = jax.grad(lambda a: jboxes.ciou(a, jnp.asarray(b2)).sum())(jnp.asarray(b1))
    close(g, jg, 1e-4)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_pairwise_iou_kinds_match_jax(kind):
    rng = np.random.default_rng(1)
    b1, b2 = rand_xyxy(rng, (2, 7)), rand_xyxy(rng, (2, 5))
    got = boxes.pairwise_iou(t(b1), t(b2), kind)
    want = jboxes.pairwise_iou(jnp.asarray(b1), jnp.asarray(b2), kind)
    assert got.shape == (2, 7, 5)
    close(got, want)


def test_pairwise_iou_unknown_kind():
    with pytest.raises(ValueError, match="unknown iou kind"):
        boxes.pairwise_iou(torch.zeros(1, 4), torch.zeros(1, 4), "wiou")


def assign_inputs(seed, b=2, m=4):
    """Anchors of two levels, scores and boxes, padded ground truths; many
    anchors lie outside every box, so their align metrics are exactly 0 and
    the top-k meets ties."""
    rng = np.random.default_rng(seed)
    pts = []
    for (h, w), s in zip(LEVEL_HW, STRIDES):
        ys, xs = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
        pts.append(np.stack([xs, ys], -1).reshape(-1, 2) * s)
    anchors = np.concatenate(pts).astype(np.float32)
    a = len(anchors)
    scores = rng.uniform(0, 1, (b, a, NC)).astype(np.float32)
    pd = np.concatenate([anchors - rng.uniform(2, 20, (b, a, 2)),
                         anchors + rng.uniform(2, 20, (b, a, 2))], -1).astype(np.float32)
    gt = rand_xyxy(rng, (b, m))
    labels = rng.integers(0, NC, (b, m)).astype(np.int32)
    mask = np.ones((b, m), bool)
    mask[:, -1] = False
    gt[~mask] = 0.0
    return scores, pd, anchors, labels, gt, mask


@pytest.mark.parametrize("seed", range(3))
def test_assign_matches_jax_and_loops(seed):
    args = assign_inputs(seed)
    got = assigner.assign(*(t(a) for a in args), num_classes=NC)
    want = jassigner.assign(*(jnp.asarray(a) for a in args), num_classes=NC)
    assert np.array_equal(got.fg_mask.numpy(), np.asarray(want.fg_mask))
    assert got.fg_mask.any()
    close(got.target_bboxes, want.target_bboxes)
    close(got.target_scores, want.target_scores)
    ref_boxes, ref_scores, ref_fg = naive_assign(*(np.asarray(a, np.float64) if a.dtype == np.float32
                                                   else a for a in args), NC)
    assert np.array_equal(got.fg_mask.numpy(), ref_fg)
    close(got.target_scores, ref_scores, 1e-4)


def detection_scene(seed):
    rng = np.random.default_rng(seed)
    b, m = 2, 4
    no = 4 * REG_MAX + NC
    maps = [rng.normal(0, 0.7, size=(b, h, w, no)).astype(np.float32) for h, w in LEVEL_HW]
    cxy = rng.uniform(0.15, 0.85, size=(b, m, 2))
    wh = rng.uniform(0.1, 0.5, size=(b, m, 2))
    gt_boxes = np.concatenate([cxy, wh], -1).astype(np.float32)
    gt_labels = rng.integers(0, NC, size=(b, m)).astype(np.int32)
    gt_mask = np.ones((b, m), bool)
    gt_mask[:, -1] = False
    gt_boxes[~gt_mask] = 0.0
    return maps, gt_labels, gt_boxes, gt_mask


KW = dict(num_classes=NC, strides=STRIDES, reg_max=REG_MAX)


@pytest.mark.parametrize("seed", range(3))
def test_yolo_detection_loss_matches_jax_and_reference(seed):
    maps, labels, gt, mask = detection_scene(seed)
    xs = [t(m).requires_grad_() for m in maps]
    got = losses.yolo_detection_loss(xs, t(labels), t(gt), t(mask), **KW)

    def jloss(*ms):
        return jlosses.yolo_detection_loss(list(ms), jnp.asarray(labels), jnp.asarray(gt),
                                           jnp.asarray(mask), **KW)

    want = jloss(*(jnp.asarray(m) for m in maps))
    for name in ("total", "box", "cls", "dfl"):
        close(getattr(got, name), getattr(want, name))
    ref_box, ref_cls, ref_dfl = ref_compute_loss(
        [m.transpose(0, 3, 1, 2).astype(np.float64) for m in maps], labels,
        gt.astype(np.float64), mask, nc=NC, reg_max=REG_MAX, strides=STRIDES,
        box_gain=7.5, cls_gain=0.5, dfl_gain=1.5)
    for g, w in ((got.box, ref_box), (got.cls, ref_cls), (got.dfl, ref_dfl)):
        np.testing.assert_allclose(float(g), w, rtol=2e-4)
    grads = torch.autograd.grad(got.total, xs)
    jgrads = jax.grad(lambda *ms: jloss(*ms).total, argnums=(0, 1))(
        *(jnp.asarray(m) for m in maps))
    scale = max(float(np.abs(np.asarray(g)).max()) for g in jgrads)
    for g, w in zip(grads, jgrads):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-4 * scale


def test_yolo_detection_loss_no_valid_gt():
    maps, labels, gt, mask = detection_scene(0)
    mask[:] = False
    gt[:] = 0.0
    got = losses.yolo_detection_loss([t(m) for m in maps], t(labels), t(gt), t(mask), **KW)
    want = jlosses.yolo_detection_loss([jnp.asarray(m) for m in maps], jnp.asarray(labels),
                                       jnp.asarray(gt), jnp.asarray(mask), **KW)
    assert float(got.box) == 0.0 and float(got.dfl) == 0.0
    close(got.cls, want.cls)


def pose_inputs(seed, b=3, k=17, h=8, w=6):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 0.3, (b, k, h, w)).astype(np.float32)
    target = np.clip(rng.normal(0, 0.3, (b, k, h, w)), 0, 1).astype(np.float32)
    weight = rng.choice([0.0, 0.5, 1.0], (b, k)).astype(np.float32)
    weight[0, :12] = 0.0  # tied zeros: OHKM picks among them by index
    return pred, target, weight


@pytest.mark.parametrize("ohkm", [True, False])
def test_joints_mse_loss_matches_jax_with_gradient(ohkm):
    pred, target, weight = pose_inputs(3)
    x = t(pred).requires_grad_()
    got = losses.joints_mse_loss(x, t(target), t(weight), use_ohkm=ohkm, ohkm_topk=8)

    def jl(p):
        return jlosses.joints_mse_loss(p, jnp.asarray(target), jnp.asarray(weight),
                                       use_ohkm=ohkm, ohkm_topk=8)

    close(got, jl(jnp.asarray(pred)))
    (g,) = torch.autograd.grad(got, x)
    jg = np.asarray(jax.grad(jl)(jnp.asarray(pred)))
    assert float(np.abs(g.numpy() - jg).max()) <= 1e-4 * float(np.abs(jg).max())
    # the same joints carry gradient: OHKM chose the same ones
    assert np.array_equal(g.numpy() != 0, jg != 0)


def keypoint_inputs(seed, b=4, k=17):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (b, k, 2)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.05, (b, k, 2)), 0, 1).astype(np.float32)
    vis = rng.integers(0, 3, (b, k)).astype(np.float32)
    vis[1] = 0.0  # an image without visible keypoints
    areas = rng.uniform(0.01, 0.5, (b,)).astype(np.float32)
    return pred, target, vis, areas


def test_oks_loss_matches_jax_with_gradient():
    pred, target, vis, areas = keypoint_inputs(4)
    x = t(pred).requires_grad_()
    got = losses.oks_loss(x, t(target), t(vis), t(areas), loss_weight=0.5)

    def jl(p):
        return jlosses.oks_loss(p, jnp.asarray(target), jnp.asarray(vis), jnp.asarray(areas),
                                loss_weight=0.5)

    close(got, jl(jnp.asarray(pred)))
    (g,) = torch.autograd.grad(got, x)
    close(g, jax.grad(jl)(jnp.asarray(pred)), 1e-4)


@pytest.mark.parametrize("scale", [1.0, 256.0])
def test_pck_accuracy_matches_jax(scale):
    pred, target, vis, areas = keypoint_inputs(5)
    areas = areas * scale * scale
    got = losses.pck_accuracy(t(pred * scale), t(target * scale), t(vis), t(areas))
    want = jlosses.pck_accuracy(jnp.asarray(pred * scale), jnp.asarray(target * scale),
                                jnp.asarray(vis), jnp.asarray(areas))
    assert float(got) == float(want)


@pytest.mark.parametrize("name", ["bce_with_logits", "quality_focal_loss", "varifocal_loss",
                                  "focal_loss"])
def test_binary_losses_match_jax(name):
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, (5, 40)).astype(np.float32)
    targets = np.where(rng.uniform(size=(5, 40)) < 0.3, rng.uniform(size=(5, 40)), 0.0
                       ).astype(np.float32)
    x = t(logits).requires_grad_()
    got = getattr(losses, name)(x, t(targets))
    close(got, getattr(jlosses, name)(jnp.asarray(logits), jnp.asarray(targets)))
    (g,) = torch.autograd.grad(got.sum(), x)
    jg = jax.grad(lambda a: getattr(jlosses, name)(a, jnp.asarray(targets)).sum())(
        jnp.asarray(logits))
    close(g, jg, 1e-4)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    logits = (rng.normal(0, 5, (6, 1000))).astype(np.float32)
    labels = rng.integers(0, 1000, (6,)).astype(np.int32)
    got = losses.softmax_cross_entropy(t(logits), t(labels))
    close(got, jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("normalize,with_areas", [("peak", True), ("peak", False),
                                                  ("sum", True)])
def test_generate_target_heatmaps_matches_jax(normalize, with_areas):
    rng = np.random.default_rng(8)
    b, n, k = 2, 3, 17
    kpts = rng.uniform(0, 1, (b, n, k, 2)).astype(np.float32)
    vis = rng.integers(0, 3, (b, n, k)).astype(np.float32)
    vis[1, 2] = 0.0  # a padding instance
    areas = rng.uniform(100, 40000, (b, n)).astype(np.float32) if with_areas else None
    kw = dict(heatmap_size=(16, 12), sigma=2.0, normalize=normalize)
    got_hm, got_w = heatmap.generate_target_heatmaps(
        t(kpts), t(vis), None if areas is None else t(areas), **kw)
    want_hm, want_w = jheatmap.generate_target_heatmaps(
        jnp.asarray(kpts), jnp.asarray(vis), None if areas is None else jnp.asarray(areas), **kw)
    assert got_hm.shape == (b, k, 16, 12)
    close(got_hm, want_hm)
    close(got_w, want_w, 0.0)


def test_generate_target_heatmaps_unknown_normalize():
    with pytest.raises(ValueError):
        heatmap.generate_target_heatmaps(torch.zeros(1, 1, 17, 2), torch.ones(1, 1, 17), None,
                                         heatmap_size=(4, 4), normalize="max")
