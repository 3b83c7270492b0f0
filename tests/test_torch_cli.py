"""The port's serving CLIs and host image IO on the CPU: ``data/image.py``
against PIL and the JAX package's functions, ``cli/infer.py`` (its JSON
and its path against the JAX cascade on the same weights),
``cli/export.py`` (``torch.export`` round trips, the bf16 checkpoint) and
``cli/build_model.py`` (fresh init, component files converted in)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from prpe_tpu.core.config import CascadeConfig as JCascadeConfig
from prpe_tpu.core.config import DetectionConfig as JDetectionConfig
from prpe_tpu.core.config import PoseConfig as JPoseConfig
from prpe_tpu.data import image as jimage
from prpe_tpu.infer.cascade import CascadeModel as JCascadeModel
from prpe_tpu.infer.cascade import build_cascade_runner as jbuild
from prpe_tpu_torch.cli import build_model, export, infer
from prpe_tpu_torch.core.config import AdaFaceConfig, CombinedModelConfig, PoseConfig
from prpe_tpu_torch.data import image
from prpe_tpu_torch.models import porting
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.models.porting import from_jax_variables
from test_torch_models import random_variables
from torch_one_thread import torch_on_one_thread  # noqa: F401

SCORE_TOL = 1e-5  # sigmoid scores, cosine similarities, softmax keypoint scores
KPT_TOL = 1e-3  # px


def _png(path, size=128, seed=0):
    """The JAX package's CLI test image: dark noise with a bright block."""
    rng = np.random.default_rng(seed)
    img = (rng.random((size, size, 3)) * 60).astype(np.uint8)
    img[30:100, 40:90] = [220, 180, 160]
    Image.fromarray(img).save(path)
    return str(path)


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 127 // (h + w)], -1)
    return np.where(rng.random((h, w, 1)) < 0.5, smooth,
                    rng.integers(0, 256, (h, w, 3))).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [((128, 96), (640, 640)), ((640, 480), (112, 112)),
                                     ((300, 200), (256, 192)), ((97, 61), (33, 150))])
def test_resize_image_matches_pil(src, dst):
    """Up and down: at most one grey level from PIL's BILINEAR, under 0.25
    levels on average (the JAX package's ``resize_image`` is PIL's)."""
    img = _scene(sum(src), *src)
    want = jimage.resize_image(img, dst).astype(int)
    got = image.resize_image(img, dst)
    assert got.dtype == np.uint8 and got.shape == (*dst, 3)
    d = np.abs(got.astype(int) - want)
    assert d.max() <= 1 and d.mean() < 0.25, (d.max(), d.mean())


def test_load_letterbox_normalize_match_jax(tmp_path):
    path = _png(tmp_path / "a.png", size=96, seed=3)
    np.testing.assert_array_equal(image.load_image(path), jimage.load_image(path))
    img = _scene(4, 90, 60)
    got, scale, pad = image.letterbox(img, 128, pad_value=114)
    want, wscale, wpad = jimage.letterbox(img, 128, pad_value=114)
    assert (scale, pad) == (wscale, wpad)
    assert np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(image.normalize_imagenet(img), jimage.normalize_imagenet(img))
    assert image.resize_image(img, (90, 60)) is img


TINY_POSE = dict(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32, vit_layers=1,
                 vit_heads=2)


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX tiny cascade's variables and the port's ``--preset tiny``
    model with the same weights."""
    jmodel = JCascadeModel(detection=JDetectionConfig(pre_nms_top_k=64),
                           pose_cfg=JPoseConfig(**TINY_POSE), irnet_layers=18)
    variables = random_variables(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 112, 112, 3)),
        jnp.zeros((1, 64, 48, 3)), method="init_all"), seed=5)
    pmodel = infer.build_model("tiny", device="cpu")
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, pmodel


def test_infer_run_matches_jax_cli_path(tiny_models, tmp_path):
    """``run`` against the JAX CLI's steps on the same weights and frames:
    frames / 255, the gallery from (x - 0.5) / 0.5 in BGR through IR-Net,
    the cascade at the match threshold. Threshold -1 matches every face,
    so persons are gated and posed."""
    jmodel, variables, pmodel = tiny_models
    frames = np.stack([np.asarray(Image.open(_png(tmp_path / f"s{i}.png", seed=i)))
                       for i in range(2)])
    enroll = np.stack([np.asarray(Image.open(_png(tmp_path / f"f{i}.png", 112, 9 + i)))
                       for i in range(2)])
    crops = (jnp.asarray(enroll, jnp.float32) / 255.0 - 0.5) / 0.5
    gallery, _ = jax.jit(lambda v, c: jmodel.apply(v, c, method="embed"))(variables, crops[..., ::-1])
    jres = jbuild(jmodel, JCascadeConfig(match_threshold=-1.0))(
        variables, jnp.asarray(frames, jnp.float32) / 255.0, gallery)
    jres = jax.tree_util.tree_map(np.asarray, jres)
    torch.testing.assert_close(infer.embed_gallery(pmodel, enroll).numpy(), np.asarray(gallery),
                               atol=SCORE_TOL, rtol=0)
    results = infer.run(pmodel, frames, enroll, -1.0, names=["s0", "s1"])
    assert [r["image"] for r in results] == ["s0", "s1"]
    n_poses = 0
    for b, r in enumerate(results):
        pv, fv = jres.persons.valid[b], jres.faces.valid[b]
        np.testing.assert_allclose(sorted(p["score"] for p in r["persons"]),
                                   np.sort(jres.persons.scores[b][pv]), atol=SCORE_TOL, rtol=0)
        np.testing.assert_allclose(sorted(f["similarity"] for f in r["faces"]),
                                   np.sort(jres.face_similarity[b][fv]), atol=SCORE_TOL, rtol=0)
        assert sorted(p["gated"] for p in r["persons"]) == sorted(jres.person_gated[b][pv])
        slots = np.flatnonzero(jres.pose_valid & (jres.pose_image_idx == b))
        assert len(r["poses"]) == len(slots)
        for pose, g in zip(r["poses"], slots):  # slots in score order on both sides
            np.testing.assert_allclose(pose["keypoints"], jres.pose_keypoints[g], atol=KPT_TOL,
                                       rtol=0)
            np.testing.assert_allclose(pose["scores"], jres.pose_scores[g], atol=SCORE_TOL,
                                       rtol=1e-4)
        n_poses += len(slots)
    assert n_poses > 0


def _check_schema(results, n):
    assert len(results) == n
    for r in results:
        assert set(r) == {"image", "persons", "faces", "poses"}
        for p in r["persons"]:
            assert set(p) == {"box", "score", "gated"} and len(p["box"]) == 4
        for f in r["faces"]:
            assert set(f) == {"box", "score", "identity", "similarity"}
        for pose in r["poses"]:
            assert set(pose) == {"box", "keypoints", "scores"}
            assert len(pose["keypoints"]) == 17 and len(pose["scores"]) == 17


def test_infer_main_tiny_cpu(tiny_models, tmp_path, capsys):
    """The CLI on PNGs with ``--device cpu --preset tiny`` (the JAX
    package's CLI test), with the tiny weights above as a bf16 checkpoint
    from ``save_inference_checkpoint``; then to stdout without one."""
    imgs = [_png(tmp_path / f"scene{i}.png", seed=i) for i in range(2)]
    enroll = _png(tmp_path / "face.png", size=112, seed=9)
    ckpt = export.save_inference_checkpoint(tiny_models[2], tmp_path / "tiny.pt")
    out = tmp_path / "results.json"
    assert infer.main(imgs + ["--enroll", enroll, "--preset", "tiny", "--image-size", "128",
                              "--device", "cpu", "--checkpoint", str(ckpt),
                              "--output", str(out), "--match-threshold", "-1"]) == 0
    results = json.loads(out.read_text())
    _check_schema(results, 2)
    assert [r["image"] for r in results] == imgs
    assert sum(len(r["poses"]) for r in results) > 0
    capsys.readouterr()
    assert infer.main(imgs[:1] + ["--preset", "tiny", "--image-size", "96", "--device", "cpu"]) == 0
    _check_schema(json.loads(capsys.readouterr().out), 1)


@pytest.mark.parametrize("name", ["vitpose", "combined_pose", "irnet", "yolo"])
def test_export_round_trip(name, tmp_path):
    """``cli.export.main`` on the CPU: the saved program loads, gives the
    eager outputs, and the ViT programs hold the packed-attention kernel as
    the node ``prpe::mhsa_packed``."""
    path = tmp_path / f"{name}.pt2"
    assert export.main(["--model", name, "--preset", "tiny", "--device", "cpu", "--image-size",
                        "64", "--batch-size", "2", "--output", str(path)]) == 0
    program = export.load_program(path)
    model, x = export.build_program(name, 2, 64, "tiny", "cpu")
    x = torch.rand(x.shape, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, got = model(x), program.module()(x)
    for g, w in zip(*((o,) if isinstance(o, torch.Tensor) else o for o in (got, want))):
        assert torch.equal(g, w)
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert ("prpe.mhsa_packed.default" in targets) == (name in ("vitpose", "combined_pose"))


def test_save_inference_checkpoint(tmp_path):
    state = {"w": torch.randn(3, 2), "n": torch.tensor([1, 2]), "flag": torch.tensor([True])}
    path = export.save_inference_checkpoint(state, tmp_path / "c.pt")
    got = torch.load(path, weights_only=True)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], state["w"].bfloat16())
    assert got["n"].dtype == torch.int64 and torch.equal(got["n"], state["n"])
    assert got["flag"].dtype == torch.bool


def _tiny_cfg():
    return CombinedModelConfig(backbone_stages=(1, 1, 1, 1),
                               face=AdaFaceConfig(arch="ir_18", num_classes=12),
                               pose=PoseConfig(**TINY_POSE))


def test_build_variables_empty_dir_is_fresh_init(tmp_path):
    logs = []
    model, state = build_model.build_variables(tmp_path, _tiny_cfg(), log=logs.append,
                                               device="cpu")
    fresh = CombinedModel(_tiny_cfg(), device="cpu", seed=0).state_dict()
    assert list(state) == list(fresh)
    for k in fresh:
        assert torch.equal(state[k], fresh[k]), k
    assert len(logs) == 5 and all(line.startswith("[fresh init]") for line in logs)


def test_build_variables_converts_components(tmp_path):
    """Reference component files in the directory: each converted into its
    branch; the detection heads keep their fresh nc = 1 class convs and the
    face branch its fresh 64-channel input layer."""
    from test_porting_yolo_irnet import TIRNet, TYolo, _TTrunk

    torch.manual_seed(0)
    trunk, yolo, ir = _TTrunk((1, 1, 1, 1)), TYolo(nc=80), TIRNet(num_layers=18)
    torch.save(trunk.state_dict(), tmp_path / "resnet50.pth")
    torch.save({"model": yolo.state_dict()}, tmp_path / "yolo11n.pt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in ir.state_dict().items()}},
               tmp_path / "adaface_ir50_ms1mv2.ckpt")
    model, state = build_model.build_variables(tmp_path, _tiny_cfg(), log=lambda s: None,
                                               device="cpu")
    fresh = CombinedModel(_tiny_cfg(), device="cpu", seed=0).state_dict()
    expect = {"backbone": porting.port_resnet50(trunk.state_dict(), (1, 1, 1, 1)),
              "yolo_person": porting.port_yolo(yolo.state_dict()),
              "yolo_face": porting.port_yolo(yolo.state_dict()),
              "ada_face": porting.port_irnet(ir.state_dict(), 18, skip_input_layer=True)}
    for branch, sd in expect.items():
        for k, v in sd.items():
            if "cls0_out" in k or "cls1_out" in k or "cls2_out" in k:
                assert torch.equal(state[f"{branch}.{k}"], fresh[f"{branch}.{k}"])
            else:
                assert torch.equal(state[f"{branch}.{k}"], v), f"{branch}.{k}"
    assert torch.equal(state["ada_face.input_conv.weight"], fresh["ada_face.input_conv.weight"])
    assert state["ada_face.input_conv.weight"].shape[1] == 64
    assert torch.equal(state["vit_pose.head.conv.weight"], fresh["vit_pose.head.conv.weight"])


def test_build_model_main(tmp_path, capsys):
    out = tmp_path / "out" / "combined.pt"
    assert build_model.main(["--component-dir", str(tmp_path / "none"), "--output", str(out),
                             "--device", "cpu"]) == 0
    state = torch.load(out, weights_only=True)
    assert state["face_kernel"].shape == (512, 85742)
    assert float(state["margin_mean"]) == 20.0
