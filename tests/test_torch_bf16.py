"""The port's bf16 models against the JAX package in **fp32**, on the CPU.

Never against JAX bf16: the JAX package's own bf16 path is itself off from
its fp32 one (its pose leg fails its own criterion on trained weights), so
JAX bf16 serves only as the yardstick. Each test states two limits on the
port's error, each output's max abs error over the largest magnitude of
the JAX fp32 output:

* ``REL_LIMIT`` on every output (the port's bf16 modules were found at
  0.001-0.012 on these weights);
* the worst output's error at most ``YARDSTICK`` times the worst error of
  the JAX package's own bf16 path against its fp32 path, on the same
  weights and inputs.

Weights are numpy-filled JAX variable trees (fp32) carried across by
``from_jax_variables``; both bf16 paths keep fp32 parameters and compute
in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.core.config import CascadeConfig as JCascadeConfig
from prpe_tpu.core.config import DetectionConfig as JDetectionConfig
from prpe_tpu.core.config import PoseConfig as JPoseConfig
from prpe_tpu.infer.cascade import CascadeModel as JCascadeModel
from prpe_tpu.infer.cascade import build_cascade_runner as jbuild
from prpe_tpu.models.combined import CombinedModel as JCombinedModel
from prpe_tpu.nn.irnet import IRNet as JIRNet
from prpe_tpu.nn.vit import ViTPose as JViTPose
from prpe_tpu.nn.yolo import YOLO as JYOLO
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.core.config import CascadeConfig, DetectionConfig, PoseConfig
from prpe_tpu_torch.infer.cascade import CascadeModel, build_cascade_runner
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.nn.irnet import IRNet
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.nn.yolo import YOLO
from test_torch_combined import tiny_config
from test_torch_models import port_module, random_variables
from torch_one_thread import torch_on_one_thread  # noqa: F401

REL_LIMIT = 0.02
YARDSTICK = 1.5
BF16 = torch.bfloat16


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np_leaves(tree):
    return [np.asarray(t, np.float32) for t in jax.tree_util.tree_leaves(tree)]


def check(port, jax32, jax16):
    """``port``, ``jax32`` and ``jax16``: the same outputs as lists of
    arrays. Applies both limits; returns (port errors, JAX bf16 errors)."""
    port_errs = [rel_err(p, w) for p, w in zip(port, jax32, strict=True)]
    jax_errs = [rel_err(j, w) for j, w in zip(jax16, jax32, strict=True)]
    assert max(port_errs) <= REL_LIMIT, port_errs
    assert max(port_errs) <= YARDSTICK * max(jax_errs), (port_errs, jax_errs)
    return port_errs, jax_errs


def _module_case(jcls, pcls, kw, x, pkw=None):
    jm32, jm16 = jcls(**kw), jcls(**kw, dtype=jnp.bfloat16)
    v = random_variables(lambda: jm32.init(jax.random.key(0), jnp.asarray(x)))
    want32 = _np_leaves(jax.jit(jm32.apply)(v, jnp.asarray(x)))
    want16 = _np_leaves(jax.jit(jm16.apply)(v, jnp.asarray(x)))
    pm = port_module(lambda: pcls(**(pkw or kw), dtype=BF16), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    got = [t.float().numpy() for t in (got if isinstance(got, (list, tuple)) else [got])]
    return check(got, want32, want16)


def test_bf16_yolo():
    """YOLOv11-n at 128^2: the three raw per-level maps."""
    x = np.random.default_rng(20).uniform(size=(2, 128, 128, 3)).astype(np.float32)
    _module_case(JYOLO, YOLO, dict(nc=1, variant="n"), x)


def test_bf16_irnet18():
    """IR-18 at 112^2: embedding and (fp32) norm."""
    x = np.random.default_rng(21).normal(size=(2, 112, 112, 3)).astype(np.float32)
    _module_case(JIRNet, IRNet, dict(num_layers=18), x)


@pytest.mark.parametrize("mode", ["pallas_packed", "einsum"])
def test_bf16_vitpose_2layer(mode, monkeypatch):
    """A 2-layer ViTPose (width 64, 4 heads) at 64x48, under the default
    attention mode (the packed kernel's plain version) and ``einsum``."""
    monkeypatch.setenv("PRPE_ATTN_MODE", mode)
    x = np.random.default_rng(22).normal(size=(2, 64, 48, 3)).astype(np.float32)
    _module_case(JViTPose, ViTPose, dict(image_size=(64, 48), hidden=64, layers=2, heads=4), x)


def test_bf16_combined_tiny():
    """The tiny combined model: both detection branches' maps, the face
    logits, the heatmaps, the embedding and its norm."""
    x = np.random.default_rng(23).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.array([1, 7], np.int32)
    j32 = JCombinedModel(config=tiny_config(jcfg))
    j16 = JCombinedModel(config=tiny_config(jcfg), dtype=jnp.bfloat16)
    v = random_variables(lambda: j32.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(labels),
                                          method="init_all"))
    v["batch_stats"]["margin_mean"] = np.float32(30.0)
    v["batch_stats"]["margin_std"] = np.float32(20.0)

    def outputs(m, x, labels):
        return m.init_all(x, labels), m.embed_face(x)

    args = (v, jnp.asarray(x), jnp.asarray(labels))
    want32 = _np_leaves(jax.jit(lambda *a: j32.apply(*a, method=outputs))(*args))
    want16 = _np_leaves(jax.jit(lambda *a: j16.apply(*a, method=outputs))(*args))
    pm = CombinedModel(tiny_config(pcfg), BF16, device="cpu")
    pm.load_state_dict(from_jax_variables(v), strict=True)
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    with torch.no_grad():
        (person, face, logits, heatmaps), (emb, norm) = pm.init_all(xt, lt), pm.embed_face(xt)
    got = [t.float().numpy() for t in (*person, *face, logits, heatmaps, emb, norm)]
    check(got, want32, want16)


POSE = dict(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32, vit_layers=1, vit_heads=2)
CFG = dict(max_persons=4, max_faces=4, match_threshold=-1.0, conf_threshold=0.0)


def test_bf16_cascade_tiny():
    """The tiny cascade (YOLOv11-n at 128^2, IR-18, a 1-layer ViT at
    64x48), every candidate valid and every face matched, on the outputs
    that do not hinge on a discrete choice: each image's person and face
    scores after NMS, in sorted order. (Which faces fill the top-F slots,
    and so the crops that are embedded and posed, can change with a
    rounding on either bf16 path; the IR-18 and ViTPose cases above hold
    those stages.)"""
    jmodel = JCascadeModel(detection=JDetectionConfig(pre_nms_top_k=64),
                           pose_cfg=JPoseConfig(**POSE), irnet_layers=18)
    variables = random_variables(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 128, 128, 3)), jnp.zeros((1, 112, 112, 3)),
        jnp.zeros((1, 64, 48, 3)), method="init_all"), seed=6)
    rng = np.random.default_rng(24)
    images = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    gallery = rng.normal(size=(3, 512)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)

    def fields(persons_scores, faces_scores):
        return [np.sort(a.float().numpy() if isinstance(a, torch.Tensor)
                        else np.asarray(a, np.float32), axis=-1)
                for a in (persons_scores, faces_scores)]

    wants = []
    for dtype in (jnp.float32, jnp.bfloat16):
        jm = JCascadeModel(detection=JDetectionConfig(pre_nms_top_k=64),
                           pose_cfg=JPoseConfig(**POSE), irnet_layers=18, dtype=dtype)
        res = jbuild(jm, JCascadeConfig(**CFG), pose_capacity=3)(
            variables, jnp.asarray(images), jnp.asarray(gallery))
        wants.append(fields(res.persons.scores, res.faces.scores))
    pm = CascadeModel(DetectionConfig(pre_nms_top_k=64), PoseConfig(**POSE), irnet_layers=18,
                      dtype=BF16, device="cpu")
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    res = build_cascade_runner(pm, CascadeConfig(**CFG), pose_capacity=3, device="cpu")(
        torch.from_numpy(images), torch.from_numpy(gallery))
    got = fields(res.persons.scores, res.faces.scores)
    assert bool(res.pose_valid.all()) and torch.isfinite(res.pose_keypoints).all()
    check(got, *wants)
