"""The port's data layer (``prpe_tpu_torch/data/``, ``native.py``,
``tools/make_dataset.py``) against PIL and the JAX package's, on the CPU.

Tolerance: equality throughout. The PNG and BMP decoders give PIL's decode
bit for bit; the native binding compiles the same C++ source with the same
flags as the JAX package's and gives its outputs bit for bit (its numpy
plain versions differ from it by at most one grey level, as the JAX
package's own ``tests/test_native.py`` allows); each reader, from the same
files and seed, gives the JAX reader's samples and batches bit for bit,
flips included, on a directory written by the repository's
``tools/make_synthetic_multitask_data.py`` (PIL; faces and pose as JPEG) and
on one written by the port's ``tools/make_dataset.py`` (PNG); the sampler's
indices, the epoch loaders' batches at 0 and 2 workers and a packed
directory's bytes equal the JAX package's.
"""

import pathlib
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from prpe_tpu import native as jnative
from prpe_tpu.data import detection as jdet
from prpe_tpu.data import faces as jfaces
from prpe_tpu.data import packed as jpacked
from prpe_tpu.data import pipeline as jpipe
from prpe_tpu.data import pose as jpose
from prpe_tpu_torch import native
from prpe_tpu_torch.data import detection, faces, image, packed, pipeline, pose
from prpe_tpu_torch.tools import make_dataset
from prpe_tpu_torch.train.steps import to_device
from torch_one_thread import torch_on_one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# --------------------------------------------------------------- images ---

def _contents(shape, seed):
    rng = np.random.default_rng(seed)
    smooth = (np.add.outer(np.arange(shape[0]), np.arange(shape[1]))[..., None]
              * np.array([3, 5, 7]) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    return {"smooth": smooth, "noise": noise, "posterised": noise // 64 * 64}


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 5, 3), (33, 47, 3)])
def test_png_decoder_equals_pil(mode, shape, tmp_path):
    """PIL picks a filter per row (None, Sub, Up, Average, Paeth); with and
    without ``optimize``."""
    for name, img in _contents(shape, sum(shape)).items():
        for kw in ({}, {"optimize": True}):
            path = tmp_path / f"{name}.png"
            Image.fromarray(img).convert(mode).save(path, **kw)
            with Image.open(path) as im:
                want = np.asarray(im.convert("RGB"))
            got = image.load_image(path)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} {name} {kw}")


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_read_back_by_pil_and_decoder(channels, tmp_path):
    img = np.random.default_rng(channels).integers(0, 256, (19, 23, channels), dtype=np.uint8)
    path = tmp_path / "w.png"
    image.save_png(path, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(np.asarray(im).reshape(img.shape), img)
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image.load_image(path), want)


def test_bmp_decoder_equals_pil(tmp_path):
    for shape in [(1, 1, 3), (7, 5, 3), (33, 47, 3)]:
        for name, img in _contents(shape, 1).items():
            path = tmp_path / f"{name}.bmp"
            Image.fromarray(img).save(path)
            with Image.open(path) as im:
                want = np.asarray(im.convert("RGB"))
            np.testing.assert_array_equal(image.load_image(path), want, err_msg=name)


def test_unsupported_images_raise_naming_the_file(tmp_path, monkeypatch):
    grey16 = tmp_path / "grey16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(grey16)
    with pytest.raises(RuntimeError, match="grey16.png.*bit depth 16"):
        image.load_image(grey16)
    jpg = tmp_path / "photo.jpg"
    Image.fromarray(_contents((16, 16, 3), 0)["noise"]).save(jpg)
    with Image.open(jpg) as im:
        np.testing.assert_array_equal(image.load_image(jpg), np.asarray(im.convert("RGB")))
    monkeypatch.setattr(image, "_HAVE_PIL", False)
    with pytest.raises(RuntimeError, match="photo.jpg.*PIL"):
        image.load_image(jpg)
    for name, cut in (("cut.png", 60), ("cut.bmp", 100)):
        whole = tmp_path / f"whole{name[-4:]}"
        Image.fromarray(_contents((16, 16, 3), 0)["noise"]).save(whole)
        (tmp_path / name).write_bytes(whole.read_bytes()[:cut])
        with pytest.raises(RuntimeError, match=name):
            image.load_image(tmp_path / name)


# --------------------------------------------------------------- native ---

def test_native_binding_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    for shape, (dh, dw), size in (((37, 53, 3), (24, 48), 64), ((40, 80, 3), (80, 40), 48),
                                  ((64, 64, 3), (64, 64), 64)):
        src = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(native.resize_bilinear_u8(src, dh, dw),
                                      jnative.resize_bilinear_u8(src, dh, dw))
        got, want = native.letterbox_u8(src, size), jnative.letterbox_u8(src, size)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        for bgr in (False, True):
            np.testing.assert_array_equal(native.resize_normalize(src, dh, dw, mean, std, bgr),
                                          jnative.resize_normalize(src, dh, dw, mean, std, bgr))
            got = native.letterbox_normalize(src, size, mean, std, bgr)
            want = jnative.letterbox_normalize(src, size, mean, std, bgr)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
            plain = native.letterbox_normalize_plain(src, size, mean, std, bgr)
            np.testing.assert_allclose(plain[0], got[0], atol=1e-4)
            assert plain[1] == pytest.approx(got[1], rel=1e-6)  # fp64 against fp32
            assert plain[2] == got[2]
        np.testing.assert_array_equal(native.hsv_lut(src, 1.1, 0.8, 1.3),
                                      jnative.hsv_lut(src, 1.1, 0.8, 1.3))
        inv = np.array([[0.9, 0.1, 2.0], [-0.1, 0.9, -3.0]], np.float32)
        np.testing.assert_array_equal(native.warp_affine_u8(src, inv, dh, dw),
                                      jnative.warp_affine_u8(src, inv, dh, dw))
        d = np.abs(native.resize_bilinear_u8_plain(src, dh, dw).astype(int)
                   - native.resize_bilinear_u8(src, dh, dw))
        assert d.max() <= 1  # exact .5 ties round apart (float64 coordinates)
        d = np.abs(native.hsv_lut_plain(src, 1.1, 0.8, 1.3).astype(int)
                   - native.hsv_lut(src, 1.1, 0.8, 1.3))
        assert (d <= 1).mean() > 0.999 and d.max() <= 3
        np.testing.assert_array_equal(native.hsv_lut_plain(src, 1.1, 0.8, 1.3),
                                      jnative._np_hsv_lut(src, 1.1, 0.8, 1.3))


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No silent numpy fallback: a source that does not compile raises."""
    bad = tmp_path / "host_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.resize_bilinear_u8(np.zeros((4, 4, 3), np.uint8), 2, 2)
    assert not list((tmp_path / "build").glob("*.so"))


# -------------------------------------------------------------- readers ---

@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same four layouts written by the repository's tools (PIL) and by
    the port's (its own PNG writer): detection 64^2, faces 32^2, pose 64^2."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import make_synthetic_multitask_data as jtool
    finally:
        sys.path.remove(str(ROOT / "tools"))
    jroot = tmp_path_factory.mktemp("jax_tool")
    for task, seeds in (("person", (0, 1)), ("face", (2, 3))):
        jtool.make_det_split(jroot / task, "train", 8, 64, seed=seeds[0])
        jtool.make_det_split(jroot / task, "val", 4, 64, seed=seeds[1])
    jtool.make_faces(jroot / "faces", n_ids=4, per_id=10, size=32)
    jtool.make_pose_split(jroot / "pose", "train", 8, 64, seed=4)
    jtool.make_pose_split(jroot / "pose", "val", 4, 64, seed=5)
    proot = make_dataset.make_dataset(tmp_path_factory.mktemp("port_tool"), 8, 4, det_size=64,
                                      pose_size=64, face_size=32, identities=4, per_identity=10)
    return {"jax_tool": jroot, "port_tool": proot}


def readers(root, split, augment):
    """(port, JAX) reader pairs at image size 48 (a resize from 64)."""
    kw = dict(augment=augment)
    return {
        "person": (detection.YoloTxtDataset(root / "person", split, 48, 6, seed=3, **kw),
                   jdet.YoloTxtDataset(root / "person", split, 48, 6, seed=3, **kw)),
        "faces": (faces.IdentityFolderDataset(root / "faces", split, 40, **kw),
                  jfaces.IdentityFolderDataset(root / "faces", split, 40, **kw)),
        "pose": (pose.CocoKeypointDataset(root / "pose", split, image_size=48, max_instances=2,
                                          seed=3, **kw),
                 jpose.CocoKeypointDataset(root / "pose", split, image_size=48, max_instances=2,
                                           seed=3, **kw)),
    }


@pytest.mark.parametrize("tool", ["jax_tool", "port_tool"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_readers_equal_the_jax_readers(datasets, tool, split):
    pairs = readers(datasets[tool], split, augment=split == "train")
    plain = readers(datasets[tool], split, augment=False)
    for name, (p, j) in pairs.items():
        assert len(p) == len(j) > 0, name
        flipped = 0
        for i in range(len(p)):
            a = p[i]
            same(a, j[i])
            flipped += not np.array_equal(a["image"], plain[name][0][i]["image"])
        if split == "train":  # augment=True flips about half
            assert 0 < flipped < len(p), (name, flipped)


def test_port_tool_writes_the_repository_tools_detection_pixels(datasets):
    for split in ("train", "val"):
        jfiles = sorted((datasets["jax_tool"] / "person" / "images" / split).iterdir())
        pfiles = sorted((datasets["port_tool"] / "person" / "images" / split).iterdir())
        assert [f.name for f in jfiles] == [f.name for f in pfiles]
        for jf, pf in zip(jfiles, pfiles):
            np.testing.assert_array_equal(image.load_image(pf), np.asarray(Image.open(jf)))
            assert (jf.parents[2] / "labels" / split / f"{jf.stem}.txt").read_text() == \
                (pf.parents[2] / "labels" / split / f"{pf.stem}.txt").read_text()
    jann = (datasets["jax_tool"] / "pose" / "annotations" / "person_keypoints_val2017.json")
    pann = (datasets["port_tool"] / "pose" / "annotations" / "person_keypoints_val2017.json")
    assert jann.read_text().replace(".jpg", ".png") == pann.read_text()


# ------------------------------------------------------------- pipeline ---

def test_limited_sampler_equals_jax_and_reads_torch_distributed(monkeypatch):
    for kw in (dict(), dict(max_samples=10), dict(shuffle=False, max_samples=40),
               dict(shard_index=1, shard_count=3, max_samples=25, seed=5)):
        p = pipeline.LimitedSampler(100, **kw)
        j = jpipe.LimitedSampler(100, **kw)
        for epoch in range(3):
            np.testing.assert_array_equal(p.indices(epoch), j.indices(epoch))
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    s = pipeline.LimitedSampler(100, max_samples=40)
    assert (s.shard_index, s.shard_count) == (2, 4)
    np.testing.assert_array_equal(
        s.indices(1), jpipe.LimitedSampler(100, 40, shard_index=2, shard_count=4).indices(1))
    loader = pipeline.make_epoch_loader(ArithmeticDataset(64), 4, max_samples=40, prefetch=0)
    assert loader.steps_per_epoch == 40 // 4 // 4


class ArithmeticDataset:
    def __init__(self, n=32, hw=8, bad=None):
        self.n, self.hw, self.bad = n, hw, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"corrupt record {i}")
        rng = np.random.default_rng(i)
        return {"image": rng.integers(0, 256, (self.hw, self.hw, 3), dtype=np.uint8),
                "label": np.int32(i)}


class UnitImages(ArithmeticDataset):
    """Images normalised by /255 on the host, which packing quantises."""

    def __getitem__(self, i):
        s = super().__getitem__(i)
        return {"image": s["image"].astype(np.float32) / 255.0, "label": s["label"]}


@pytest.mark.parametrize("workers", [0, 2])
def test_epoch_loader_batches_equal_jax(datasets, workers):
    """The readers through ``make_epoch_loader`` (train: shuffled, capped)
    give the JAX loader's batches, in order, over two epochs; augmented at
    0 workers. With workers, which worker draws a batch's flips depends on
    which is free first, in both packages (ROADMAP.md §3), so the augmented
    batches are compared inline only."""
    root = datasets["port_tool"]
    for name, (p, j) in readers(root, "train", augment=workers == 0).items():
        pl = pipeline.make_epoch_loader(p, 2, max_samples=6, seed=4, num_workers=workers)
        jl = jpipe.make_epoch_loader(j, 2, max_samples=6, seed=4, num_workers=workers,
                                     prefetch=0)
        try:
            assert pl.steps_per_epoch == jl.steps_per_epoch == 3
            for epoch in (0, 1):
                got = [{k: np.array(v) for k, v in b.items()} for b in pl(epoch)]
                want = [{k: np.array(v) for k, v in b.items()} for b in jl.host(epoch)]
                assert len(got) == len(want) == 3
                for g, w in zip(got, want):
                    same(g, w)
            assert pl.stats["batches"] == 6 and pl.stats["wait_s"] >= 0.0
        finally:
            pl.close()
            jl.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_a_failing_record_raises_in_the_consumer(workers):
    """A reader's exception, in the prefetch thread or in a decode worker,
    reaches the consumer: the epoch does not end quietly, and the cleanup
    does not wait for the failed batch. The loader serves the next epoch
    afterwards."""
    ds = ArithmeticDataset(32, bad=13)
    loader = pipeline.make_epoch_loader(ds, 4, shuffle=False, num_workers=workers)
    try:
        got = []
        t0 = time.monotonic()
        with pytest.raises((ValueError, RuntimeError), match="corrupt record 13"):
            for b in loader(0):
                got.append(b["label"].copy())
        assert time.monotonic() - t0 < 60  # the pool's timeout is 300 s
        if workers == 0:
            assert len(got) == 3  # the batches before the bad one arrive
            ds.bad = None
            assert len(list(loader(1))) == 8
        else:
            # a worker's error is raised as it comes in, possibly ahead of
            # earlier batches still decoding; the forked workers hold the
            # dataset as it was
            assert len(got) <= 3
            with pytest.raises(RuntimeError, match="corrupt record 13"):
                list(loader(1))
    finally:
        loader.close()


def test_prefetch_closed_early_stops_the_producer_and_frees_the_pool():
    ds = ArithmeticDataset(64)
    loader = pipeline.make_epoch_loader(ds, 4, shuffle=False, num_workers=2, prefetch=2)
    try:
        it = loader(0)
        first = next(it)
        assert first["label"].tolist() == [0, 1, 2, 3]
        it.close()
        labels = np.concatenate([b["label"] for b in loader(1)])
        np.testing.assert_array_equal(labels, np.arange(64))
    finally:
        loader.close()


def test_prefetch_on_the_cpu_copies_host_batches_and_to_device_is_a_no_op():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    out = list(pipeline.prefetch_to_device(iter(batches), 2, "cpu"))
    for b, w in zip(out, batches):
        same(b, w)
        assert b["x"] is not w["x"]
    dev = {"x": torch.ones(2, 3), "m": torch.zeros(2, dtype=torch.bool)}
    moved = to_device(dev, torch.device("cpu"))
    assert all(moved[k] is dev[k] for k in dev)  # tensors already there: no copy


# --------------------------------------------------------------- packed ---

def test_pack_dataset_round_trip_equals_jax(datasets, tmp_path):
    p, j = readers(datasets["port_tool"], "val", augment=False)["pose"]
    got = packed.pack_dataset(p, tmp_path / "port", image_norm="imagenet")
    want = jpacked.pack_dataset(j, tmp_path / "jax", image_norm="imagenet")
    names = sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "port").iterdir())
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    assert len(got) == len(want) == len(p)
    for i in range(len(p)):
        same(got[i], want[i])
        same(got[i], p[i])
    idx = np.array([2, 0, 1])
    same(got.gather(idx), want.gather(idx))
    same(packed.PackedDataset.collate([got[0], got[1]]),
         jpacked.PackedDataset.collate([want[0], want[1]]))
    idx = np.arange(len(p))
    same(next(iter(got.batches(idx, 2))), next(iter(want.batches(idx, 2))))
    for norm in ("unit", None):
        a = packed.pack_dataset(UnitImages(6), tmp_path / f"pu{norm}", image_norm=norm)
        b = jpacked.pack_dataset(UnitImages(6), tmp_path / f"ju{norm}", image_norm=norm)
        for i in range(6):
            same(a[i], b[i])
        assert (tmp_path / f"pu{norm}" / "meta.json").read_bytes() == \
            (tmp_path / f"ju{norm}" / "meta.json").read_bytes()
