"""Port crop-and-resize and heatmap decode against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.ops import heatmap as jheatmap
from prpe_tpu.ops import roi as jroi
from prpe_tpu.ops.anchors import dfl_decode as jdfl_decode, make_anchors as jmake_anchors
from prpe_tpu_torch.ops import heatmap as pheatmap
from prpe_tpu_torch.ops import roi as proi
from prpe_tpu_torch.ops.anchors import dfl_decode, make_anchors


def test_crop_and_resize_batch():
    """Boxes inside, across and outside the image edge, and a degenerate
    padding box; fp32 on both sides (1e-5)."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(3, 40, 56, 3)).astype(np.float32)
    boxes = np.array([[4.2, 3.1, 30.7, 22.9], [-6.0, 10.0, 20.0, 50.0],
                      [50.0, 30.0, 70.0, 45.0], [0.0, 0.0, 0.0, 0.0],
                      [10.5, 12.25, 11.0, 30.0]], np.float32)
    idx = np.array([0, 2, 1, 0, 2])
    for out_hw in ((16, 12), (9, 23)):
        want = jroi.crop_and_resize_batch(jnp.asarray(images), jnp.asarray(boxes),
                                          jnp.asarray(idx), out_hw)
        got = proi.crop_and_resize_batch(torch.from_numpy(images), torch.from_numpy(boxes),
                                         torch.from_numpy(idx), out_hw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _heatmaps(seed=0):
    rng = np.random.default_rng(seed)
    hm = rng.normal(size=(3, 17, 16, 12)).astype(np.float32)
    hm[0, 0] = 0.0  # all-equal map: argmax must take the first cell
    hm[1, 2, 5, 4] = hm[1, 2, 9, 1] = 10.0  # tied peaks
    return hm


@pytest.mark.parametrize("method", ["argmax", "soft"])
def test_decode_heatmaps(method):
    """argmax: coordinates exact; soft and the softmax scores: 1e-6."""
    hm = _heatmaps()
    boxes = np.array([[0, 0, 50, 80], [10, 10, 300, 400], [5, 5, 6, 7]], np.float32)
    for bx in (None, boxes):
        want_c, want_s = jheatmap.decode_heatmaps(
            jnp.asarray(hm), None if bx is None else jnp.asarray(bx), method=method)
        got_c, got_s = pheatmap.decode_heatmaps(
            torch.from_numpy(hm), None if bx is None else torch.from_numpy(bx), method=method)
        if method == "argmax":
            np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
        else:
            np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-7)


def test_flip_heatmaps():
    hm = _heatmaps(1)
    assert tuple(np.asarray(jheatmap.COCO_FLIP_PERM)) == pheatmap.COCO_FLIP_PERM
    np.testing.assert_array_equal(pheatmap.flip_heatmaps(torch.from_numpy(hm)).numpy(),
                                  np.asarray(jheatmap.flip_heatmaps(jnp.asarray(hm))))


def test_anchors_and_dfl_decode():
    level_hw, strides = [(16, 16), (8, 8), (4, 4)], (8, 16, 32)
    ja, js = jmake_anchors(level_hw, strides)
    pa, ps = make_anchors(level_hw, strides)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    dist = np.random.default_rng(2).normal(size=(2, pa.shape[0], 64)).astype(np.float32)
    np.testing.assert_allclose(dfl_decode(torch.from_numpy(dist), pa).numpy(),
                               np.asarray(jdfl_decode(jnp.asarray(dist), ja)),
                               rtol=1e-5, atol=1e-5)
