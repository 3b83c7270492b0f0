"""The whole serving slice: the port's cascade against the JAX cascade on the
CPU, in fp32, on the same weights and the same images.

One tiny component stack (the ``tests/test_cascade.py`` geometry: YOLOv11-n
at 128^2, IR-18, a 1-layer ViTPose at 64x48) and one JAX compile per cascade
config keep this file inside the fast tier. ``conf_threshold=0.0`` makes
every candidate valid, so both NMS passes scan the full candidate list, and
the gallery holds two embeddings of detected faces so that some faces match.
Two more JAX compiles run the cascade with the ViT attention under
``PRPE_ATTN_MODE=pallas_lnfused`` and ``pallas_bh``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core.config import CascadeConfig as JCascadeConfig
from prpe_tpu.core.config import DetectionConfig as JDetectionConfig
from prpe_tpu.core.config import PoseConfig as JPoseConfig
from prpe_tpu.infer.cascade import CascadeModel as JCascadeModel
from prpe_tpu.infer.cascade import build_cascade_runner as jbuild
from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.ops.roi import crop_and_resize_batch
from test_torch_models import random_variables

_spec = importlib.util.spec_from_file_location(
    "check_cascade_numerics",
    pathlib.Path(__file__).resolve().parents[1] / "tools" / "check_cascade_numerics.py")
_numerics = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_numerics)
_greedy_match = _numerics._greedy_match

POSE = dict(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32, vit_layers=1, vit_heads=2)
CFG = dict(max_persons=4, max_faces=4, match_threshold=0.9, conf_threshold=0.0)
POSE_CAPACITY = 3

BOX_TOL = 1e-3  # px, fp32 conv sums in another order, scaled by the stride
SCORE_TOL = 1e-5  # sigmoid scores and cosine similarities
KPT_TOL = 1e-3  # px: argmax keypoints, box-scaled


@pytest.fixture(scope="module")
def slice_models():
    """The JAX cascade, its variables, the port cascade with the same
    weights, the images and the gallery."""
    jmodel = JCascadeModel(detection=JDetectionConfig(pre_nms_top_k=64),
                           pose_cfg=JPoseConfig(**POSE), irnet_layers=18)
    variables = random_variables(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 112, 112, 3)),
        jnp.zeros((1, 64, 48, 3)), method="init_all"))
    pmodel = CascadeModel(DetectionConfig(pre_nms_top_k=64), PoseConfig(**POSE),
                          irnet_layers=18, device="cpu")
    pmodel.load_state_dict(from_jax_variables(variables), strict=True)

    rng = np.random.default_rng(3)
    images = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    # gallery: two detected faces' own embeddings plus two random identities
    first = build_cascade_runner(pmodel, CascadeConfig(**CFG), pose_capacity=POSE_CAPACITY,
                                 device="cpu")(torch.from_numpy(images), torch.zeros(4, 512))
    boxes = first.faces.boxes[:, 0]  # the best face of each image
    with torch.no_grad():
        crops = crop_and_resize_batch(torch.from_numpy(images), boxes, torch.arange(2), (112, 112))
        emb, _ = pmodel.irnet(((crops - 0.5) / 0.5).flip(-1))
    rand = rng.normal(size=(2, 512)).astype(np.float32)
    gallery = np.concatenate([emb.numpy(), rand / np.linalg.norm(rand, axis=1, keepdims=True)])
    return jmodel, variables, pmodel, images, gallery


def run_both(slice_models, **cfg):
    """(JAX outputs as numpy, port outputs) of one cascade config, under
    the current ``PRPE_ATTN_MODE``: a fresh JAX runner traces it anew."""
    jmodel, variables, pmodel, images, gallery = slice_models
    jres = jbuild(jmodel, JCascadeConfig(**cfg, **CFG),
                  pose_capacity=POSE_CAPACITY)(variables, jnp.asarray(images), jnp.asarray(gallery))
    prun = build_cascade_runner(pmodel, CascadeConfig(**cfg, **CFG),
                                pose_capacity=POSE_CAPACITY, device="cpu")
    pres = prun(torch.from_numpy(images), torch.from_numpy(gallery))
    return (jax.tree_util.tree_map(np.asarray, jres._asdict()), pres), prun


@pytest.fixture(scope="module")
def slice_pair(slice_models):
    """(JAX runner outputs, port outputs) per cascade config, same weights."""
    out = {}
    for flip in (False, True):
        out[flip], prun = run_both(slice_models, pose_flip_test=flip)
    return out, prun, slice_models[3], slice_models[4]


@pytest.fixture(scope="module")
def mode_pairs(slice_models):
    """(JAX outputs, port outputs) with the ViT attention under two other
    ``PRPE_ATTN_MODE`` values: the fused half-block and the (B, H, T, D)
    kernel with one head per TPU program."""
    out = {}
    for mode in ("pallas_lnfused", "pallas_bh"):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PRPE_ATTN_MODE", mode)
            out[mode], _ = run_both(slice_models)
    return out


def _slot_map(jdet, pdet):
    """Per image, the port slot of each JAX detection slot: valid slots paired
    as matched sets by box IoU, padding slots in order."""
    perm = np.zeros(jdet["valid"].shape, np.int64)
    for b in range(perm.shape[0]):
        jv = np.flatnonzero(jdet["valid"][b])
        pv = np.flatnonzero(pdet.valid[b].numpy())
        assert len(jv) == len(pv)
        pairs = _greedy_match(jdet["boxes"][b][jv], pdet.boxes[b][pv].numpy(), thr=0.99)
        assert len(pairs) == len(jv), "every valid detection must find its twin"
        for i, j, _ in pairs:
            perm[b, jv[i]] = pv[j]
        pad_j = np.flatnonzero(~jdet["valid"][b])
        pad_p = np.flatnonzero(~pdet.valid[b].numpy())
        perm[b, pad_j] = pad_p
    return perm


def _take(x, perm):
    return np.take_along_axis(np.asarray(x), perm.reshape(perm.shape + (1,) * (np.ndim(x) - 2)), 1)


def assert_fields_match(jres, pres):
    maps = {}
    for name in ("persons", "faces"):
        jdet = jres[name]._asdict()
        pdet = getattr(pres, name)
        perm = maps[name] = _slot_map(jdet, pdet)
        assert jdet["valid"].all(), "conf_threshold=0 makes every slot valid"
        np.testing.assert_allclose(_take(pdet.boxes, perm), jdet["boxes"], atol=BOX_TOL, rtol=0)
        np.testing.assert_allclose(_take(pdet.scores, perm), jdet["scores"], atol=SCORE_TOL, rtol=0)
        np.testing.assert_array_equal(_take(pdet.classes, perm), jdet["classes"])

    fperm, pperm = maps["faces"], maps["persons"]
    np.testing.assert_array_equal(_take(pres.face_identity, fperm), jres["face_identity"])
    assert (jres["face_identity"] >= 0).sum() >= 2, "the gallery must match some faces"
    np.testing.assert_allclose(_take(pres.face_similarity, fperm), jres["face_similarity"],
                               atol=SCORE_TOL, rtol=0)
    np.testing.assert_array_equal(_take(pres.person_gated, pperm), jres["person_gated"])
    assert bool(pres.face_budget_saturated) == bool(jres["face_budget_saturated"])

    # pose slots: the same (image, box) per slot, then keypoints and scores
    np.testing.assert_array_equal(pres.pose_valid.numpy(), jres["pose_valid"])
    np.testing.assert_array_equal(pres.pose_image_idx.numpy(), jres["pose_image_idx"])
    np.testing.assert_allclose(pres.pose_boxes.numpy(), jres["pose_boxes"], atol=BOX_TOL, rtol=0)
    np.testing.assert_allclose(pres.pose_keypoints.numpy(), jres["pose_keypoints"],
                               atol=KPT_TOL, rtol=0)
    np.testing.assert_allclose(pres.pose_scores.numpy(), jres["pose_scores"],
                               atol=SCORE_TOL, rtol=1e-4)
    for field in pres._fields:
        value = getattr(pres, field)
        for t in (value if isinstance(value, tuple) else (value,)):
            if t.is_floating_point():
                assert torch.isfinite(t).all(), field


@pytest.mark.parametrize("flip", [False, True])
def test_cascade_fields_match_jax(slice_pair, flip):
    (pairs, _, _, _) = slice_pair
    assert_fields_match(*pairs[flip])


@pytest.mark.parametrize("mode", ["pallas_lnfused", "pallas_bh"])
def test_cascade_fields_match_jax_under_attn_mode(mode_pairs, mode):
    assert_fields_match(*mode_pairs[mode])


def test_flip_changes_keypoints(slice_pair):
    (pairs, _, _, _) = slice_pair
    base, flip = pairs[False][1], pairs[True][1]
    assert torch.equal(base.pose_valid, flip.pose_valid)
    assert not torch.allclose(base.pose_keypoints, flip.pose_keypoints)


def test_uint8_input_matches_unit_float(slice_pair):
    """uint8 pixels are scaled by 1/255 inside the runner."""
    (_, prun, images, gallery) = slice_pair
    u8 = np.rint(images * 255).astype(np.uint8)
    g = torch.from_numpy(gallery)
    a = prun(torch.from_numpy(u8), g)
    b = prun(torch.from_numpy(u8.astype(np.float32) / 255.0), g)
    assert torch.equal(a.persons.valid, b.persons.valid)
    assert torch.equal(a.face_identity, b.face_identity)
    torch.testing.assert_close(a.persons.boxes, b.persons.boxes, atol=1e-3, rtol=0)
    torch.testing.assert_close(a.pose_keypoints, b.pose_keypoints, atol=1e-3, rtol=0)
