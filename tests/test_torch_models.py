"""Port models (``prpe_tpu_torch.nn``) against the JAX models on the CPU.

Both sides get the same weights: the JAX variable tree is filled from a
numpy seed and carried into the port by ``from_jax_variables``. Inputs come
from numpy too. Everything runs in fp32; the stated tolerance is relative
to the largest magnitude of the JAX output.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core import config as jax_config
from prpe_tpu.nn import common as jcommon
from prpe_tpu.nn.irnet import IRNet as JIRNet
from prpe_tpu.nn.vit import ViTPose as JViTPose
from prpe_tpu.nn.yolo import YOLO as JYOLO, decode_predictions as jdecode
from prpe_tpu_torch.core import config as port_config
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.nn import common as pcommon
from prpe_tpu_torch.nn.irnet import IRNet
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.nn.yolo import YOLO, decode_predictions
from torch_one_thread import torch_on_one_thread  # noqa: F401

REL_TOL = 1e-4  # fp32 on both sides; convolution sums differ in order only


def random_variables(init_fn, seed=0):
    """Variable tree with the shapes ``init_fn()`` would give, filled from a
    numpy seed: non-trivial BatchNorm statistics and scales, small biases,
    lecun-scaled kernels."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.normal(0.0, fan_in ** -0.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "alpha":
            v = rng.uniform(0.1, 0.4, shape)
        elif name == "pos_embed":
            v = rng.normal(0.0, 0.02, shape)
        else:  # bias, mean
            v = 0.1 * rng.normal(size=shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(shapes))


def port_module(factory, variables):
    """Build a port module on the CPU and load the carried-over weights."""
    m = pcommon.build_on(torch.device("cpu"), factory)
    m.load_state_dict(from_jax_variables(variables), strict=True)
    return m


def assert_rel(got, want, tol=REL_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} * {scale}"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("name", ["DetectionConfig", "PoseConfig", "CascadeConfig", "AdaFaceConfig",
                                  "CombinedModelConfig", "OptimConfig", "DataConfig",
                                  "TaskConfig", "TrainConfig"])
def test_config_fields_match(name):
    want = dataclasses.asdict(getattr(jax_config, name)())
    got = dataclasses.asdict(getattr(port_config, name)())
    assert got == want


def test_default_task_configs_match():
    want = [dataclasses.asdict(t) for t in jax_config.default_task_configs()]
    assert [dataclasses.asdict(t) for t in port_config.default_task_configs()] == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fast_gelu(dtype):
    x = np.random.default_rng(1).normal(0, 2, (64, 33)).astype(np.float32)
    want = np.asarray(jcommon.fast_gelu(jnp.asarray(x, dtype)), np.float32)
    got = pcommon.fast_gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    # bf16: both take the tanh form; one bf16 rounding step apart at most
    tol = 1e-6 if dtype == "float32" else 1.6e-2
    assert_rel(got, want, tol)


@pytest.mark.parametrize("k,s,p,groups,act", [(3, 2, 1, 1, True), (1, 1, 0, 1, False),
                                              (3, 1, 1, 8, True)])
def test_conv_bn(k, s, p, groups, act):
    """ConvBN with the inference BatchNorm fold (random running statistics)."""
    jm = jcommon.ConvBN(8, k, strides=s, padding=p, groups=groups,
                        act=jax.nn.silu if act else None)
    x = np.random.default_rng(2).normal(size=(2, 12, 12, 8)).astype(np.float32)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jm.apply(v, jnp.asarray(x))
    pm = port_module(lambda: pcommon.ConvBN(8, 8, k, s, p, groups=groups, act=act), v)
    assert_rel(to_nhwc(pm(nchw(x))), want)


def test_prelu():
    x = np.random.default_rng(3).normal(size=(2, 5, 5, 6)).astype(np.float32)
    jm = jcommon.PReLU()
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    pm = port_module(lambda: pcommon.PReLU(6), v)
    assert_rel(to_nhwc(pm(nchw(x))), jm.apply(v, jnp.asarray(x)), 1e-7)


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_pool_upsample(align_corners):
    x = np.random.default_rng(4).normal(size=(2, 7, 5, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), nchw(x)
    assert_rel(to_nhwc(pcommon.bilinear_resize(xt, (28, 17), align_corners)),
               jcommon.bilinear_resize(xj, (28, 17), align_corners))
    assert_rel(to_nhwc(pcommon.nearest_upsample(xt)), jcommon.nearest_upsample(xj), 0.0)
    for window, stride, pad in ((5, 1, 2), (3, 2, 1)):
        assert_rel(to_nhwc(pcommon.max_pool(xt, window, stride, pad)),
                   jcommon.max_pool(xj, window, stride, pad), 0.0)


def test_yolo_maps_and_decode():
    """YOLOv11-n (nc=1) raw per-level maps and decoded boxes at 128^2."""
    x = np.random.default_rng(5).uniform(size=(2, 128, 128, 3)).astype(np.float32)
    jm = JYOLO(nc=1, variant="n")
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want_maps = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: YOLO(nc=1, variant="n"), v)
    with torch.no_grad():
        got_maps = pm(torch.from_numpy(x))
    for g, w in zip(got_maps, want_maps):
        assert_rel(g.numpy(), w)
    want = jdecode(want_maps, 1, 16)
    got = decode_predictions(got_maps, 1, 16).numpy()
    assert_rel(got, want)


def test_irnet18_embedding_and_norm():
    x = np.random.default_rng(6).normal(size=(2, 112, 112, 3)).astype(np.float32)
    jm = JIRNet(num_layers=18)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want_emb, want_norm = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: IRNet(num_layers=18), v)
    with torch.no_grad():
        emb, norm = pm(torch.from_numpy(x))
    assert_rel(emb.numpy(), want_emb)
    assert_rel(norm.numpy(), want_norm)


def test_vitpose_tiny_heatmaps():
    """ViTPose, 1 layer, hidden 32, 2 heads, at 64x48 -> (B, 17, 16, 12)."""
    x = np.random.default_rng(7).normal(size=(2, 64, 48, 3)).astype(np.float32)
    kw = dict(image_size=(64, 48), hidden=32, layers=1, heads=2)
    jm = JViTPose(**kw)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: ViTPose(**kw), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, 17, 16, 12)
    assert_rel(got.numpy(), want)
