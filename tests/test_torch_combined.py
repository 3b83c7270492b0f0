"""The combined multi-task model and its modules against the JAX package on
the CPU, in fp32: the ResNet trunk, the three adapters, the IR-Net variants
(64-channel input, IR-SE, the bottleneck unit, IR-152/200 layouts), the
margin heads, the classic ViTPose decoder and a tiny ``CombinedModel``.

Weights are numpy-filled JAX variable trees carried across by
``from_jax_variables``; inputs come from numpy seeds. Tolerances are
relative to the largest magnitude of the JAX output (at least 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.models.combined import CombinedModel as JCombinedModel
from prpe_tpu.nn import adapters as jadapters
from prpe_tpu.nn import irnet as jirnet
from prpe_tpu.nn.resnet import ResNetTrunk as JResNetTrunk
from prpe_tpu.nn.vit import ClassicDecoder as JClassicDecoder
from prpe_tpu.nn.vit import ViTPose as JViTPose
from prpe_tpu.ops import margin as jmargin
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.nn import adapters, irnet
from prpe_tpu_torch.nn.common import build_on
from prpe_tpu_torch.nn.resnet import ResNetTrunk
from prpe_tpu_torch.nn.vit import ClassicDecoder, ViTPose
from prpe_tpu_torch.ops import margin
from test_torch_models import assert_rel, nchw, port_module, random_variables, to_nhwc
from torch_one_thread import torch_on_one_thread  # noqa: F401

CPU = torch.device("cpu")


def tiny_config(m):
    """The tiny combined model of these tests, from config module ``m``:
    a (1, 1, 1, 1) trunk, detection adapters at 32^2, IR-18 on 32^2 with
    10 classes, a 1-layer ViT of width 32 at 64x48."""
    return m.CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1),
        detection=m.DetectionConfig(adapter_size=(32, 32)),
        face=m.AdaFaceConfig(arch="ir_18", num_classes=10, input_size=(32, 32)),
        pose=m.PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                          vit_layers=1, vit_heads=2))


def test_resnet_trunk():
    """(1, 1, 1, 1) trunk at 64^2 -> (2, 2, 2, 2048), NHWC on both sides."""
    x = np.random.default_rng(10).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jm = JResNetTrunk(stage_sizes=(1, 1, 1, 1))
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: ResNetTrunk((1, 1, 1, 1)), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 2048)
    assert_rel(got.numpy(), want)


@pytest.mark.parametrize("name,target", [("YoloAdapter", (8, 8)), ("AdaFaceAdapter", (12, 12)),
                                         ("VitPoseAdapter", (16, 12))])
def test_adapter(name, target):
    """Each adapter at a small target. The YOLO adapter's standardisation
    uses the population std: over 8 x 8 values the unbiased one would be
    0.8 % larger and miss this tolerance by an order of magnitude."""
    x = np.random.default_rng(11).normal(size=(2, 3, 2, 2048)).astype(np.float32)
    jm = getattr(jadapters, name)(target_size=target)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: getattr(adapters, name)(target), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == want.shape
    assert_rel(got.numpy(), want)


def test_yolo_adapter_population_std():
    """Before the sigmoid, each image and channel of the pseudo-image has
    the population std s / (s + 1e-6), s the population std of the stage
    output (the unbiased std would give 0.8 % less over 8 x 8 values)."""
    pm = build_on(CPU, lambda: adapters.YoloAdapter((8, 8)), seed=3)
    x = torch.randn(2, 2, 2, 2048, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        s = torch.std(pm.adapt(x).double(), dim=(2, 3), correction=0)
        z = torch.logit(pm(x).double())
    std = torch.std(z, dim=(1, 2), correction=0)
    torch.testing.assert_close(std, s / (s + 1e-6), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name,channels", [("ir_18", 64), ("ir_se_18", 3)])
def test_irnet_variants(name, channels):
    """IR-18 with the combined model's 64-channel input, and IR-SE-18, on
    32^2 inputs (a 2 x 2 grid into the output linear)."""
    x = np.random.default_rng(12).normal(size=(2, 32, 32, channels)).astype(np.float32)
    jm = jirnet.build_irnet(name, input_channels=channels)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want_emb, want_norm = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: irnet.build_irnet(name, input_channels=channels, input_size=32), v)
    with torch.no_grad():
        emb, norm = pm(torch.from_numpy(x))
    assert_rel(emb.numpy(), want_emb)
    assert_rel(norm.numpy(), want_norm)


@pytest.mark.parametrize("cin,depth,stride,use_se", [(64, 256, 2, False), (256, 256, 1, True)])
def test_bottleneck_ir_unit(cin, depth, stride, use_se):
    """One BottleneckIR unit, with a conv shortcut and with the subsample
    shortcut plus SE."""
    x = np.random.default_rng(13).normal(size=(2, 8, 8, cin)).astype(np.float32)
    jm = jirnet.BottleneckIR(depth, stride, use_se)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: irnet.BottleneckIR(cin, depth, stride, use_se), v)
    with torch.no_grad():
        got = pm(nchw(x))
    assert_rel(to_nhwc(got), want)


@pytest.mark.parametrize("name", ["ir_101", "ir_se_50", "ir_152", "ir_200"])
def test_build_irnet_names(name):
    want = jirnet.build_irnet(name)
    got = irnet.build_irnet(name)
    assert (got.num_layers, got.mode) == (want.num_layers, want.mode)


@pytest.mark.parametrize("layers", [152, 200])
def test_bottleneck_depths_carry_across(layers):
    """IR-152 / IR-200 (bottleneck units, 2048 output channels): the state
    dict carried from the JAX tree has exactly the port model's keys and
    shapes. Shapes only: the JAX tree comes from ``jax.eval_shape``, the
    port model lives on the meta device."""
    jm = jirnet.IRNet(num_layers=layers)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3))))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    carried = {k: tuple(v.shape) for k, v in from_jax_variables(tree).items()}
    pm = build_on(torch.device("meta"), lambda: irnet.IRNet(num_layers=layers, input_size=32))
    want = {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert carried == want
    assert pm.output_bn.running_mean.shape == (2048,)
    assert isinstance(pm.body0, irnet.BottleneckIR)


def _margin_inputs(seed=14, b=8, e=16, c=10):
    rng = np.random.default_rng(seed)
    kernel = rng.normal(size=(e, c)).astype(np.float32)
    emb = rng.normal(size=(b, e)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    norms = rng.uniform(5.0, 40.0, (b, 1)).astype(np.float32)
    labels = rng.integers(0, c, b).astype(np.int32)
    return kernel, emb, norms, labels


@pytest.mark.parametrize("head", ["adaface_update", "adaface_frozen", "arcface", "cosface"])
def test_margin_heads(head):
    """Each head's logits, and the AdaFace EMA state with and without its
    update, against the JAX functions (fp32; logits up to s = 64)."""
    kernel, emb, norms, labels = _margin_inputs()
    jk, je, jn, jl = map(jnp.asarray, (kernel, emb, norms, labels))
    tk, te, tn, tl = map(torch.from_numpy, (kernel, emb, norms, labels))
    if head.startswith("adaface"):
        update = head == "adaface_update"
        jstate = jmargin.MarginState(jnp.float32(18.0), jnp.float32(6.0))
        want, wstate = jmargin.adaface_logits(jk, je, jn, jl, jstate, update_stats=update)
        got, gstate = margin.adaface_logits(
            tk, te, tn, tl, margin.MarginState(torch.tensor(18.0), torch.tensor(6.0)),
            update_stats=update)
        for g, w in zip(gstate, wstate):
            assert_rel(g.numpy(), w, 1e-6)
        assert (float(gstate.batch_mean) != 18.0) == update
    else:
        want = getattr(jmargin, f"{head}_logits")(jk, je, jl)
        got = getattr(margin, f"{head}_logits")(tk, te, tl)
    assert_rel(got.numpy(), want, 1e-5)
    assert_rel(margin.normalized_cosine(tk, te).numpy(), jmargin.normalized_cosine(jk, je), 1e-6)


def test_init_kernel_unit_columns():
    k = margin.init_kernel(torch.Generator().manual_seed(0), 16, 40)
    assert k.shape == (16, 40)
    torch.testing.assert_close(torch.linalg.vector_norm(k, dim=0), torch.ones(40))
    assert margin.MarginState.init() == (20.0, 100.0)


def test_classic_decoder_shapes_and_values():
    """flax ConvTranspose(4, stride 2, padding 1) gives 2n - 2 a block:
    16x12 -> 30x22 after the first deconv, 58x42 after the decoder."""
    x = np.random.default_rng(15).normal(size=(2, 16, 12, 32)).astype(np.float32)
    jm = JClassicDecoder(num_keypoints=17)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    deconv0 = jax.jit(lambda k, x: jax.lax.conv_transpose(
        x, k, (2, 2), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC")))(
        v["params"]["deconv0"]["kernel"], jnp.asarray(x))
    pm = port_module(lambda: ClassicDecoder(32, 17), v)
    with torch.no_grad():
        got0 = pm.deconv0(nchw(x))
        got = pm(nchw(x))
    assert got0.shape == (2, 256, 30, 22) and deconv0.shape == (2, 30, 22, 256)
    assert_rel(to_nhwc(got0), deconv0)
    assert got.shape == (2, 17, 58, 42)
    assert_rel(to_nhwc(got), want)


def test_vitpose_classic_decoder():
    """ViTPose(decoder="classic"), 1 layer at 64x48 -> (B, 17, 10, 6); the
    bridge flips the deconv kernels."""
    x = np.random.default_rng(16).normal(size=(2, 64, 48, 3)).astype(np.float32)
    kw = dict(image_size=(64, 48), hidden=32, layers=1, heads=2)
    jm = JViTPose(**kw, decoder="classic")
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x)))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(lambda: ViTPose(**kw, decoder="classic"), v)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert got.shape == (2, 17, 10, 6)
    assert_rel(got.numpy(), want)


@pytest.fixture(scope="module")
def combined_pair():
    """The JAX tiny combined model's outputs (``init_all`` and
    ``embed_face`` in one compile), its variables and the port model with
    the same weights, on 64^2 images with two labels."""
    jm = JCombinedModel(config=tiny_config(jcfg))
    x = np.random.default_rng(17).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    labels = np.array([1, 7], np.int32)
    v = random_variables(lambda: jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(labels),
                                         method="init_all"))
    # EMA statistics near the norms of these embeddings, so the margin moves
    v["batch_stats"]["margin_mean"] = np.float32(30.0)
    v["batch_stats"]["margin_std"] = np.float32(20.0)
    fn = jax.jit(lambda v, x, l: jm.apply(
        v, x, l, method=lambda m, x, l: (m.init_all(x, l), m.embed_face(x))))
    want = jax.tree_util.tree_map(np.asarray, fn(v, jnp.asarray(x), jnp.asarray(labels)))
    pm = CombinedModel(tiny_config(pcfg), device="cpu")
    pm.load_state_dict(from_jax_variables(v), strict=True)
    return v, want, pm, torch.from_numpy(x), torch.from_numpy(labels)


def test_combined_config_fields_match():
    assert pcfg.TASKS == jcfg.TASKS
    import dataclasses

    assert dataclasses.asdict(tiny_config(pcfg)) == dataclasses.asdict(tiny_config(jcfg))


@pytest.mark.parametrize("task", ["person_detection", "face_detection", "face_recognition",
                                  "pose_estimation", "face_logits", "init_all"])
def test_combined_tasks(combined_pair, task):
    """Each task of ``forward``, face logits without the EMA update, and
    ``init_all``, against the JAX model on the same weights."""
    _, ((person, face, logits, heatmaps), (emb, norm)), pm, x, labels = combined_pair
    with torch.no_grad():
        if task == "init_all":
            got = pm.init_all(x, labels)
            pairs = [*zip(got[0], person), *zip(got[1], face), (got[2], logits), (got[3], heatmaps)]
        elif task == "face_logits":
            pairs = [(pm(x, "face_recognition", labels, train=False), logits)]
        elif task == "face_recognition":
            pairs = list(zip(pm(x, task), (emb, norm)))
        else:
            want = {"person_detection": person, "face_detection": face,
                    "pose_estimation": heatmaps}[task]
            got = pm(x, task)
            pairs = list(zip(got, want)) if isinstance(got, list) else [(got, want)]
    for g, w in pairs:
        assert g.shape == w.shape
        assert_rel(g.numpy(), w)
    assert float(pm.margin_mean) == 30.0 and float(pm.margin_std) == 20.0


def test_combined_face_logits_train_updates_margin(combined_pair):
    """``face_logits(train=True)`` moves ``margin_mean`` / ``margin_std`` as
    the JAX head does on the same embeddings, and computes the logits from
    the moved statistics. (The port's BatchNorms stay in inference form:
    the reference is the JAX head on the inference embeddings.)"""
    v, (_, (emb, norm)), _, x, labels = combined_pair
    pm = CombinedModel(tiny_config(pcfg), device="cpu")
    pm.load_state_dict(from_jax_variables(v), strict=True)
    face = tiny_config(jcfg).face
    state = jmargin.MarginState(jnp.float32(30.0), jnp.float32(20.0))
    want, wstate = jmargin.adaface_logits(
        jnp.asarray(v["params"]["face_kernel"]), jnp.asarray(emb), jnp.asarray(norm),
        jnp.asarray(labels.numpy()), state, m=face.m, h=face.h, s=face.s, t_alpha=face.t_alpha,
        update_stats=True)
    with torch.inference_mode():
        got = pm.face_logits(x, labels, train=True)
    assert_rel(got.numpy(), want)
    assert_rel(pm.margin_mean.numpy(), wstate.batch_mean, 1e-6)
    assert_rel(pm.margin_std.numpy(), wstate.batch_std, 1e-6)
    assert float(pm.margin_mean) != 30.0 and float(pm.margin_std) != 20.0
    with torch.no_grad():
        pm.face_logits(x, labels, train=False)
    assert_rel(pm.margin_mean.numpy(), wstate.batch_mean, 1e-6)


def test_combined_unknown_task(combined_pair):
    with pytest.raises(ValueError, match="unknown task"):
        combined_pair[2](combined_pair[3], "segmentation")


def test_bridge_carries_full_width_combined_tree():
    """The default (full-width) JAX CombinedModel tree carries into the port
    model with no missing or unexpected key and every shape equal: the
    (512, 85742) ``face_kernel`` unchanged, the scalar margin buffers, the
    NHWC-row IR-50 output linear. Shapes only (``jax.eval_shape``, meta
    device)."""
    jm = JCombinedModel()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                            jnp.zeros((1,), jnp.int32), method="init_all"))
    tree = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    carried = {k: tuple(v.shape) for k, v in from_jax_variables(tree).items()}
    pm = CombinedModel(device="meta")
    assert carried == {k: tuple(v.shape) for k, v in pm.state_dict().items()}
    assert carried["face_kernel"] == (512, 85742)
    assert carried["margin_mean"] == carried["margin_std"] == ()
    assert carried["ada_face.output_linear.weight"] == (512, 512 * 7 * 7)


def test_combined_defaults():
    """A seeded model: unit-norm prototype columns and the EMA's initial
    values; the same seed gives the same weights."""
    a = CombinedModel(tiny_config(pcfg), device="cpu", seed=3)
    b = CombinedModel(tiny_config(pcfg), device="cpu", seed=3)
    torch.testing.assert_close(torch.linalg.vector_norm(a.face_kernel, dim=0), torch.ones(10))
    assert (float(a.margin_mean), float(a.margin_std)) == (20.0, 100.0)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
