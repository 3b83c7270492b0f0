"""The YOLO trainer's augmentations (``prpe_tpu_torch/data/augment.py``) and
its mosaic dataset (``data/detection.py::YoloMosaicDataset``) against the
JAX package's on the same numpy inputs and seeds.

Tolerance: equality throughout. Each function draws from its
``np.random.Generator`` in the JAX order and the pixel work runs in the
same native library (``native/host_ops.cpp``) or the same numpy code, so
one seed gives the same arrays bit for bit; the seeds and probabilities
are chosen so that every branch is taken (mosaic with and without MixUp,
the plain resize, every visual transform).
"""

import numpy as np
import pytest

from prpe_tpu.data import augment as jaug
from prpe_tpu.data import detection as jdet
from prpe_tpu.data import loader as jloader
from prpe_tpu.data import pipeline as jpipe
from prpe_tpu_torch.data import augment as aug
from prpe_tpu_torch.data import detection, pipeline
from prpe_tpu_torch.data.loader import MultiprocessLoader
from prpe_tpu_torch.tools.make_dataset import make_detection_split
from torch_one_thread import torch_on_one_thread  # noqa: F401


def same(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def image(seed, h=48, w=40):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def labels(seed, n=5):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.05, 0.4, (n, 2))
    cxy = rng.uniform(wh / 2, 1 - wh / 2)
    return np.concatenate([rng.integers(0, 3, (n, 1)), cxy, wh], 1).astype(np.float32)


def both(fn_name, *args, seed=0, **kw):
    """The port's and the JAX function on copies of the inputs, each with
    a generator seeded ``seed`` (None: no generator), and the two
    generators' next draws (equal iff they drew alike)."""
    out = []
    for mod in (aug, jaug):
        a = [np.copy(x) if isinstance(x, np.ndarray) else x for x in args]
        if seed is None:
            out.append((getattr(mod, fn_name)(*a, **kw), None))
        else:
            rng = np.random.default_rng(seed)
            out.append((getattr(mod, fn_name)(*a, rng, **kw), rng.random()))
    (got, g_next), (want, w_next) = out
    assert g_next == w_next
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hsv_augment_equals_jax(seed):
    got, want = both("hsv_augment", image(seed), seed=seed)
    same(got, want)
    got, want = both("hsv_augment", image(seed), seed=seed, h_gain=0.5, s_gain=0.0, v_gain=0.9)
    same(got, want)


@pytest.mark.parametrize("size", [64, 33])
def test_mosaic4_equals_jax(size):
    samples = [(image(i, 40 + 8 * i, 56 - 4 * i), labels(i, n=i)) for i in range(4)]
    for seed in range(3):
        got, want = both("mosaic4", samples, size, seed=seed)
        same(got, want)
        assert got[1].shape == (6, 5)


@pytest.mark.parametrize("kw", [{}, dict(degrees=30.0, shear=10.0), dict(translate=0.0, scale=0.0)])
def test_random_perspective_equals_jax(kw):
    for seed in range(4):
        got, want = both("random_perspective", image(seed, 64, 64), labels(seed, 6), seed=seed,
                         **kw)
        same(got, want)
    got, want = both("random_perspective", image(9, 64, 64), np.zeros((0, 5), np.float32),
                     seed=9, **kw)
    same(got, want)


def test_warp_affine_native_equals_jax_and_the_plain_version():
    """The library's warp equals the JAX package's on a rotation, a shear
    and a scaled translation. The port's numpy version is within one grey
    level of it on under 0.1 % of the pixels: both sample in fp32, but the
    library blends each row pair horizontally and then vertically
    (``native/host_ops.cpp:177-179``) where the numpy version sums the four
    weighted taps, so a value on a .5 of the final rounding can go either
    way."""
    img = image(4, 50, 70)
    c, s = np.cos(0.3), np.sin(0.3)
    for m in (np.array([[c, s, 5.0], [-s, c, -3.0], [0, 0, 1]]),
              np.array([[1.0, 0.2, 0.0], [0.1, 1.0, 2.5], [0, 0, 1]]),
              np.array([[1.7, 0.0, -11.25], [0.0, 0.6, 7.5], [0, 0, 1]])):
        got = aug.warp_affine(img, m, 48, 64)
        same(got, jaug.warp_affine(img, m, 48, 64))
        diff = np.abs(got.astype(int) - aug.warp_affine_plain(img, m, 48, 64).astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_box_candidates_equals_jax():
    rng = np.random.default_rng(3)
    before = np.sort(rng.uniform(0, 64, (40, 2, 2)), axis=1).reshape(40, 4)[:, [0, 2, 1, 3]]
    after = before * rng.uniform(0.0, 1.5, (40, 1)) + rng.uniform(-2, 2, (40, 4))
    after[:5, 2] = after[:5, 0] + 1.5  # narrower than 2 px
    got = aug.box_candidates(before, after)
    same(got, jaug.box_candidates(before, after))
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_blurs_equal_jax(k):
    img = image(k, 37, 29)
    same(aug.box_blur(img, k), jaug.box_blur(img, k))
    same(aug.median_blur(img, k), jaug.median_blur(img, k))


@pytest.mark.parametrize("clip", [1.0, 2.5, 4.0])
def test_gray_and_clahe_equal_jax(clip):
    img = image(int(clip * 10), 45, 70)
    same(aug.to_gray(img), jaug.to_gray(img))
    same(aug.clahe(img, clip), jaug.clahe(img, clip))
    same(aug.clahe(img, clip, tiles=4), jaug.clahe(img, clip, tiles=4))


@pytest.mark.parametrize("p", [1.0, 0.5, 0.01])
def test_random_visual_equals_jax(p):
    for seed in range(4):
        got, want = both("random_visual", image(seed, 32, 32), seed=seed, p=p)
        same(got, want)


def test_mixup_equals_jax():
    for seed in range(3):
        got, want = both("mixup", image(1), labels(1, 3), image(2), labels(2, 2), seed=seed)
        same(got, want)
        assert got[1].shape == (5, 5)


@pytest.fixture(scope="module")
def det_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    make_detection_split(root, "train", 10, 48, seed=0)
    return root


def mosaic_pair(root, size=40, seed=5, **kw):
    pbase = detection.YoloTxtDataset(root, "train", size, 8, seed=seed + 1)
    jbase = jdet.YoloTxtDataset(root, "train", size, 8, seed=seed + 1)
    return (detection.YoloMosaicDataset(pbase, seed=seed, **kw),
            jdet.YoloMosaicDataset(jbase, seed=seed, **kw))


def test_mosaic_dataset_items_equal_jax_in_every_branch(det_root, monkeypatch):
    """Mosaic at p = 0.6 and MixUp at 0.5, every visual transform at 0.3:
    every branch is taken over 16 items (counted on the port's functions),
    and every item equals the JAX dataset's."""
    counts = {}
    for name in ("mosaic4", "mixup", "random_perspective", "box_blur", "clahe", "to_gray",
                 "median_blur"):
        fn = getattr(aug, name)

        def counted(*a, _fn=fn, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(aug, name, counted)
    p, j = mosaic_pair(det_root, mosaic_prob=0.6, mixup_prob=0.5, visual_prob=0.3)
    assert len(p) == len(j) == 10
    for i in range(16):
        got, want = p[i % 10], j[i % 10]
        assert set(got) == set(want)
        for k in got:
            same(got[k], want[k])
        assert got["image"].shape == (40, 40, 3) and got["image"].dtype == np.uint8
    mosaics = counts["mosaic4"] - counts["mixup"]  # a MixUp takes a second mosaic
    assert 0 < counts["mixup"] < mosaics < 16, counts
    assert counts["random_perspective"] == 16 + counts["mixup"], counts
    assert all(counts[k] > 0 for k in ("box_blur", "clahe", "to_gray", "median_blur")), counts


def test_set_mosaic_off_equals_jax(det_root):
    p, j = mosaic_pair(det_root, seed=11)
    same(p[3]["image"], j[3]["image"])
    p.set_mosaic(0.0)
    j.set_mosaic(0.0)
    assert p.mosaic_prob == 0.0
    for i in range(10):
        got, want = p[i], j[i]
        for k in got:
            same(got[k], want[k])
        assert got["gt_mask"].any()


def test_workers_reseed_the_view_and_its_base(det_root):
    """One forked worker reseeds the view's ``_rng`` and its ``base._rng``
    as the JAX loader does (``prpe_tpu/data/loader.py:86-93``): its batches
    equal the JAX pool's and the inline items of the reseeded view."""
    def collate(samples):
        return pipeline.default_collate(samples)

    batches = [[0, 1], [2, 3], [4, 5]]
    p, j = mosaic_pair(det_root, seed=2, mosaic_prob=0.5, visual_prob=0.0)
    pool = MultiprocessLoader(p, collate, 2, num_workers=1, seed=7)
    jpool = jloader.MultiprocessLoader(j, jpipe.default_collate, 2, num_workers=1, seed=7)
    try:
        got = [{k: np.array(v) for k, v in b.items()} for b in pool.run(np.arange(6))]
        want = [{k: np.array(v) for k, v in b.items()} for b in jpool.run(np.arange(6))]
    finally:
        pool.close()
        jpool.close()
    inline, _ = mosaic_pair(det_root, seed=2, mosaic_prob=0.5, visual_prob=0.0)
    inline._rng = np.random.default_rng(7)
    inline.base._rng = np.random.default_rng(7 + 1)
    assert len(got) == len(want) == 3
    for g, w, idx in zip(got, want, batches):
        ref = collate([inline[i] for i in idx])
        for k in g:
            same(g[k], w[k])
            same(g[k], ref[k])
