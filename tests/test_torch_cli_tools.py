"""The dataset CLIs of the port (``convert_coco``, ``convert_ms1m``,
``eval_verification``, ``download_coco``, ``download_models``) against the
JAX package's on the CPU.

Tolerance: equality. The converters write the same files byte for byte;
``eval_verification`` prints the same metrics as the JAX CLI from the same
IR-18 weights (the JAX CLI's ``key(0)`` initialisation, carried into a port
checkpoint by ``from_jax_variables``). The download CLIs never reach the
network here: ``urllib.request.urlretrieve`` raises and
``huggingface_hub`` is blocked or raises, so they take their offline paths.
"""

import io
import json
import pickle
import struct
import sys
import zipfile

import numpy as np
import pytest
import torch

from prpe_tpu.cli import convert_coco as jconvert_coco
from prpe_tpu.cli import convert_ms1m as jconvert_ms1m
from prpe_tpu.cli import download_coco as jdownload_coco
from prpe_tpu_torch.cli import (
    convert_coco, convert_ms1m, download_coco, download_models, eval_verification,
)
from prpe_tpu_torch.data.image import decode_image, encode_png


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, and these small shapes gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def coco_json():
    rng = np.random.default_rng(0)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "width": 640 - 32 * i,
               "height": 480 + 16 * i} for i in range(1, 5)]
    anns = []
    for k in range(14):
        im = images[(k // 3) % 3]  # image 4 has no annotation
        x, y = rng.uniform(0, 200, 2)
        anns.append({"id": k, "image_id": im["id"], "category_id": [1, 3, 18][k % 3],
                     "bbox": [float(x), float(y), float(rng.uniform(5, 150)),
                              float(rng.uniform(5, 150))],
                     "iscrowd": int(k == 4)})
    cats = [{"id": 1, "name": "person"}, {"id": 3, "name": "car"}, {"id": 18, "name": "dog"}]
    return {"info": {"year": 2017}, "licenses": [], "images": images, "annotations": anns,
            "categories": cats}


@pytest.mark.parametrize("category", ["person", "all", "dog"])
def test_convert_coco_writes_the_jax_clis_files(tmp_path, category, capsys):
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps(coco_json()))
    assert convert_coco.main([str(ann), "--output-dir", str(tmp_path / "port"),
                              "--category", category]) == 0
    assert jconvert_coco.main([str(ann), "--output-dir", str(tmp_path / "jax"),
                               "--category", category]) == 0
    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert got == want and len(got) >= 2
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" to ")[0] == out[1].split(" to ")[0]


def record(labels, payload, flag=None):
    """One RecordIO record: IRHeader (flag, labels, two ids) + payload,
    padded to 4 bytes."""
    flag = (0 if len(labels) == 1 else len(labels)) if flag is None else flag
    body = struct.pack("<I", flag) + struct.pack(f"<{len(labels)}f", *labels)
    body += struct.pack("<QQ", 7, 9) + payload
    return (struct.pack("<II", 0xCED7230A, len(body)) + body
            + b"\0" * ((4 - len(body) % 4) % 4))


def write_rec(path):
    rng = np.random.default_rng(1)
    recs = [record([0.0, 5.0], b"")]  # an index record: no image
    for k in range(9):
        img = rng.integers(0, 256, (8 + k, 8, 3), dtype=np.uint8)
        recs.append(record([float(k % 3)], encode_png(img)[: 40 + 3 * k]))
    recs.append(record([2.0, 1.0], b"\xff\xd8jpeg-ish"))
    path.write_bytes(b"".join(recs))


@pytest.mark.parametrize("limit", [None, 4])
def test_convert_ms1m_rec_writes_the_jax_clis_folders(tmp_path, limit):
    rec = tmp_path / "train.rec"
    write_rec(rec)
    extra = [] if limit is None else ["--limit", str(limit)]
    assert convert_ms1m.main([str(rec), "--output", str(tmp_path / "port"), *extra]) == 0
    assert jconvert_ms1m.main([str(rec), "--output", str(tmp_path / "jax"), *extra]) == 0
    got = tree(tmp_path / "port")
    assert got == tree(tmp_path / "jax")
    assert len(got) == (10 if limit is None else limit)
    (tmp_path / "bad.rec").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        convert_ms1m.main([str(tmp_path / "bad.rec"), "--output", str(tmp_path / "bad")])


def test_convert_ms1m_bin_writes_the_jax_clis_npz(tmp_path):
    rng = np.random.default_rng(2)
    bins = [encode_png(rng.integers(0, 256, (6, 6, 3), dtype=np.uint8)) for _ in range(8)]
    issame = [True, False, True, False]
    src = tmp_path / "lfw.bin"
    src.write_bytes(pickle.dumps((bins, issame)))
    assert convert_ms1m.main([str(src), "--output", str(tmp_path / "port.npz")]) == 0
    assert jconvert_ms1m.main([str(src), "--output", str(tmp_path / "jax.npz")]) == 0
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "jax.npz").read_bytes()
    data = np.load(tmp_path / "port.npz", allow_pickle=True)
    assert [bytes(b) for b in data["jpegs"]] == bins and data["issame"].tolist() == issame


@pytest.fixture(scope="module")
def pairs_npz(tmp_path_factory):
    """20 pairs of 112^2 crops, PNG bytes (the port's writer) with every
    fourth pair as JPEG (PIL), matched pairs near copies of each other."""
    from PIL import Image

    rng = np.random.default_rng(3)
    imgs, issame = [], []
    for p in range(20):
        a = rng.integers(0, 256, (112, 112, 3), dtype=np.uint8)
        same = p % 2 == 0
        b = np.clip(a.astype(int) + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8) \
            if same else rng.integers(0, 256, a.shape, dtype=np.uint8)
        for img in (a, b):
            if p % 4 == 3:
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=90)
                imgs.append(buf.getvalue())
            else:
                imgs.append(encode_png(img))
        issame.append(same)
    path = tmp_path_factory.mktemp("pairs") / "pairs.npz"
    np.savez(path, jpegs=np.array(imgs, dtype=object), issame=np.asarray(issame))
    return path


def test_decode_matches_the_jax_clis_decode(pairs_npz):
    """PNG and JPEG pair images through the port's decoder give the JAX
    CLI's array: RGB / 255, (x - 0.5) / 0.5, BGR."""
    from PIL import Image

    for j in np.load(pairs_npz, allow_pickle=True)["jpegs"][:8]:
        img = np.asarray(Image.open(io.BytesIO(j)).convert("RGB"), np.float32)
        want = ((img / 255.0 - 0.5) / 0.5)[..., ::-1]
        got = eval_verification.decode(j)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_eval_verification_prints_the_jax_clis_metrics(pairs_npz, tmp_path, capsys):
    """IR-18 from the JAX CLI's own ``key(0)`` initialisation: the port's
    CLI, given those weights as a checkpoint, prints the same metrics
    (batch 16: the last of three batches is padded)."""
    import jax
    import jax.numpy as jnp

    from prpe_tpu.cli import eval_verification as jeval
    from prpe_tpu.nn.irnet import build_irnet
    from prpe_tpu_torch.models.porting import from_jax_variables
    from prpe_tpu_torch.train.checkpoint import save_model

    variables = jax.jit(build_irnet("ir_18").init)(jax.random.key(0),
                                                    jnp.zeros((1, 112, 112, 3)))
    ckpt = save_model(tmp_path / "ir18", from_jax_variables(jax.device_get(variables)))
    args = [str(pairs_npz), "--arch", "ir_18", "--batch-size", "16"]
    assert jeval.main(args) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert eval_verification.main(args + ["--device", "cpu", "--checkpoint", ckpt]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert set(got) == set(want) and got == want, (got, want)
    assert all(np.isfinite(v) for v in got.values())
    assert got["accuracy"] > 0.5  # matched pairs are near copies


def test_eval_verification_without_pil_names_the_jpeg(pairs_npz, monkeypatch):
    from prpe_tpu_torch.data import image

    monkeypatch.setattr(image, "_HAVE_PIL", False)
    data = np.load(pairs_npz, allow_pickle=True)["jpegs"]
    assert decode_image(bytes(data[0])).shape == (112, 112, 3)  # PNG: no PIL needed
    with pytest.raises(RuntimeError, match="pair image 6.*PIL"):
        eval_verification.main([str(pairs_npz), "--arch", "ir_18", "--batch-size", "16",
                                "--device", "cpu"])


def offline(monkeypatch):
    import urllib.request

    def refuse(url, *a, **k):
        raise OSError(f"no network for {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)


def test_download_coco_reports_what_is_missing_offline(tmp_path, monkeypatch, capsys):
    offline(monkeypatch)
    root = tmp_path / "coco"
    assert download_coco.main(["--output-dir", str(root)]) == 1
    out = capsys.readouterr().out
    assert "annotations_trainval2017.zip" in out
    assert f"place files manually under {root}" in out
    assert not list(root.glob("*.part"))


def test_download_coco_prepares_files_placed_by_hand(tmp_path, monkeypatch, capsys):
    """An annotations archive placed where the CLI would have written it:
    no download, and the person-only json the JAX function writes."""
    offline(monkeypatch)
    root = tmp_path / "coco"
    root.mkdir()
    with zipfile.ZipFile(root / "annotations_trainval2017.zip", "w") as z:
        z.writestr("annotations/instances_val2017.json", json.dumps(coco_json()))
    assert download_coco.main(["--output-dir", str(root), "--skip-images"]) == 0
    assert "exists:" in capsys.readouterr().out
    got = root / "annotations" / "person_instances_val2017.json"
    jdownload_coco.filter_person_instances(root / "annotations" / "instances_val2017.json",
                                           tmp_path / "jax.json")
    assert got.read_bytes() == (tmp_path / "jax.json").read_bytes()
    person = json.loads(got.read_text())
    assert {a["category_id"] for a in person["annotations"]} == {1}
    assert len(person["images"]) == 3


def test_download_models_reports_what_is_missing_offline(tmp_path, monkeypatch, capsys):
    out = tmp_path / "components"
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # not installed
    assert download_models.main(["--output-dir", str(out)]) == 1
    printed = capsys.readouterr().out
    for f in download_models.FILES:
        assert str(out / f) in printed
    assert download_models.VITPOSE_REPO in printed

    class Hub:  # installed, but no network
        @staticmethod
        def hf_hub_download(repo_id, filename, local_dir):
            raise OSError(f"no network for {filename}")

    monkeypatch.setitem(sys.modules, "huggingface_hub", Hub)
    assert download_models.main(["--output-dir", str(out)]) == 0
    printed = capsys.readouterr().out
    assert printed.count("place it manually at") == len(download_models.FILES)
    for f in download_models.FILES:
        (out / f).write_bytes(b"x")
    assert download_models.main(["--output-dir", str(out)]) == 0
    assert "all component models present" in capsys.readouterr().out


@pytest.mark.parametrize("size", [64, 256])
def test_make_dataset_jpeg_quality_matches_pil(tmp_path, size):
    """``--jpeg-quality 92``: the pose images and face crops are what PIL's
    quality-92 JPEG of the lossless images decodes to, within ~1.2 grey
    levels on average (the lossless ones differ from it by ~10)."""
    import io

    from PIL import Image

    from prpe_tpu_torch.data.image import decode_png
    from prpe_tpu_torch.tools import make_dataset as md

    md.make_pose_split(tmp_path / "png", "train", 2, size, seed=4)
    md.make_pose_split(tmp_path / "jpg", "train", 2, size, seed=4, jpeg_quality=92)
    md.make_faces(tmp_path / "fpng", 1, 2, 112)
    md.make_faces(tmp_path / "fjpg", 1, 2, 112, jpeg_quality=92)
    pairs = [(tmp_path / "png" / "images" / "train", tmp_path / "jpg" / "images" / "train"),
             (tmp_path / "fpng" / "imgs" / "id0000", tmp_path / "fjpg" / "imgs" / "id0000")]
    for lossless_dir, jpeg_dir in pairs:
        for p in sorted(lossless_dir.glob("*.png")):
            lossless = decode_png(p.read_bytes())
            got = decode_png((jpeg_dir / p.name).read_bytes()).astype(np.float64)
            buf = io.BytesIO()
            Image.fromarray(lossless).save(buf, format="JPEG", quality=92)
            want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"), np.float64)
            assert np.abs(got - want).mean() <= 1.5, p
            assert np.abs(lossless - want).mean() >= 4.0, p
