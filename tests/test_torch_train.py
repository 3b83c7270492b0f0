"""The port's train step of each task against the JAX package's on the CPU,
in fp32, from the same JAX variable tree (carried by ``from_jax_variables``)
and the same synthetic batch.

One JAX step per task, jitted once in a module-scoped fixture. Dropout is
off on both sides (``flax.linen.Dropout`` replaced by the identity while
the JAX steps trace; the port's rate set to 0): the two draw different
masks. The optimizer is SGD with Nesterov momentum and weight decay, so the
first update is lr x the clipped gradient (plus decay) and holds the
gradients element by element; Adam's first update is lr x sign(g) and
would hide them. The chains themselves are held against optax in
``tests/test_torch_optim.py``.

Tolerances. The losses and metrics agree within 1e-4 of the JAX value's
magnitude (at least 1), ``grad_norm`` within 5e-3, the running statistics
within 1e-3. Each updated parameter's change agrees within ``PARAM_TOL``
of the largest JAX change of that tensor, plus 1e-4 of the largest change
of the task (the floor covers the conv biases in front of a BatchNorm,
whose gradient is zero up to rounding). The detection and face gradients
of this tiny configuration are ill-conditioned in fp32: its BatchNorms
reduce over few elements with the fast variance E[x^2] - E[x]^2, and each
backward through them cancels large terms. Against a float64 run of the
port, JAX's own fp32 person-detection gradients are off by up to 1.2e-2 of
a tensor's largest entry and the port's by 3.6e-3; run in float64 on both
sides (too slow a compile for these tests), the face step agrees within
1.4e-4 and ``grad_norm`` within 4e-6 in person detection. Pose is well
conditioned and held at 2e-3. Face recognition runs at batch 8: at batch 2
its 1-d output BatchNorm sees two values per channel and the errors grow
fivefold.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.data import synthetic as jsynthetic
from prpe_tpu.models.combined import CombinedModel as JCombinedModel
from prpe_tpu.train import optim as joptim
from prpe_tpu.train import state as jstate
from prpe_tpu.train import steps as jsteps
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.data import synthetic
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.train.optim import build_optimizer
from prpe_tpu_torch.train.state import create_train_state
from prpe_tpu_torch.train.steps import make_train_step, trainable_mask, trainable_params
from test_torch_models import random_variables
from torch_one_thread import torch_on_one_thread  # noqa: F401

LR = 0.1


def train_config(m):
    """A (1, 1, 1, 1) trunk, detection adapters at 64^2 (three YOLO levels
    of 8^2, 4^2, 2^2 anchors, so the assigner finds foreground), IR-18 on
    32^2 with 10 classes, a 1-layer ViT of width 32 at 64x48."""
    return m.CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1), detection=m.DetectionConfig(adapter_size=(64, 64)),
        face=m.AdaFaceConfig(arch="ir_18", num_classes=10, input_size=(32, 32)),
        pose=m.PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                          vit_layers=1, vit_heads=2))


def task_batches(seed=0):
    rng = np.random.default_rng(seed)
    return {"person_detection": synthetic.detection_batch(rng, 2, 64, 4),
            "face_detection": synthetic.detection_batch(rng, 2, 64, 4),
            "face_recognition": synthetic.face_batch(rng, 8, 64, 10),
            "pose_estimation": synthetic.pose_batch(rng, 2, 64, 3)}


def jax_variables():
    jm = JCombinedModel(config=train_config(jcfg))
    x = jnp.zeros((1, 64, 64, 3))
    v = random_variables(lambda: jm.init(jax.random.key(0), x, jnp.zeros((1,), jnp.int32),
                                         method="init_all"))
    v["batch_stats"]["margin_mean"] = np.float32(30.0)
    v["batch_stats"]["margin_std"] = np.float32(20.0)
    return jm, v


def identity_dropout(rate, deterministic=None, **kw):
    return lambda x, *a, **k: x


OPTIM = dict(optimizer="sgd", learning_rate=LR, weight_decay=5e-4)
PARAM_TOL = {"person_detection": 5e-2, "face_detection": 5e-2, "face_recognition": 1e-1,
             "pose_estimation": 2e-3}


@pytest.fixture(scope="module")
def jax_tree():
    """``jax_variables()``, built once for the module's tests."""
    return jax_variables()


@pytest.fixture(scope="module")
def jax_steps(jax_tree):
    """Per task: the JAX metrics and the variables after one step."""
    jm, v = jax_tree
    batches = task_batches()
    cfg = train_config(jcfg)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", identity_dropout)
        for task in jcfg.TASKS:
            tx = jsteps.mask_optimizer(
                joptim.build_optimizer(jcfg.OptimConfig(**OPTIM), v["params"]), task)
            state = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, v), {task: tx})
            step = jsteps.make_train_step(jm, task, tx, cfg)
            new, metrics = step(state, {k: jnp.asarray(a) for k, a in batches[task].items()},
                                jax.random.key(1))
            out[task] = (jax.device_get(metrics), jax.device_get(new.variables))
    return v, batches, out


def port_model(v):
    pm = CombinedModel(train_config(pcfg), device="cpu")
    pm.load_state_dict(from_jax_variables(v), strict=True)
    pm.ada_face.dropout.rate = 0.0
    return pm


def port_step(v, task, batch, trainable="branch"):
    pm = port_model(v)
    tx = build_optimizer(pcfg.OptimConfig(**OPTIM))
    state = create_train_state(pm, {task: tx}, {task: trainable_params(pm, task, trainable)})
    step = make_train_step(pm, task, tx, train_config(pcfg), trainable=trainable)
    state, metrics = step(state, batch)
    return pm, state, metrics


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("task", jcfg.TASKS)
def test_train_step_matches_jax(jax_steps, task):
    v, batches, out = jax_steps
    want_metrics, want_vars = out[task]
    before = from_jax_variables(v)
    want = from_jax_variables(want_vars)
    pm, state, metrics = port_step(v, task, batches[task])
    assert set(metrics) == set(want_metrics)
    for k, w in want_metrics.items():
        tol = 5e-3 if k == "grad_norm" else 1e-4
        assert rel_err(metrics[k].numpy(), w) <= tol, (k, float(metrics[k]), float(w))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    got = {k: t.detach() for k, t in pm.state_dict().items()}
    mask = trainable_mask(pm, task)
    moved_params = moved_stats = 0
    task_scale = max(float(np.abs(want[k].numpy() - before[k].numpy()).max())
                     for k in mask if mask[k])
    for k, g in got.items():
        g, w, b = g.numpy(), want[k].numpy(), before[k].numpy()
        if k in mask:  # a parameter
            if not mask[k]:
                assert np.array_equal(g, b), f"frozen {k} moved"
                assert np.allclose(w, b, rtol=0, atol=0), f"JAX moved frozen {k}"
                continue
            dw, dg = w - b, g - b
            scale = float(np.abs(dw).max())
            assert float(np.abs(dg - dw).max()) <= PARAM_TOL[task] * scale + 1e-4 * task_scale, k
            moved_params += scale > 0
        else:  # running statistics and the margin EMA
            assert rel_err(g, w) <= 1e-3, k
            moved_stats += not np.array_equal(w, b)
    assert moved_params > 0 and moved_stats > 0
    # the frozen trunk's BatchNorms ran on batch statistics and moved
    assert not np.array_equal(got["backbone.bn1.running_mean"].numpy(),
                              before["backbone.bn1.running_mean"].numpy())


def test_trainable_mask_scopes(jax_tree):
    """The three scopes against the JAX masks on the same tree, through the
    bridge's names."""
    _, v = jax_tree
    pm = port_model(v)
    for scope in ("branch", "branch+backbone", "all"):
        for task in jcfg.TASKS:
            jmask = jsteps.trainable_mask(v["params"], task, scope)
            want = {k: bool(t.numpy()) for k, t in from_jax_variables(
                {"params": jax.tree_util.tree_map(lambda m: np.float32(m), jmask)}).items()}
            got = trainable_mask(pm, task, scope)
            assert got == want, (task, scope)
    with pytest.raises(ValueError, match="unknown trainable scope"):
        trainable_mask(pm, "pose_estimation", "trunk")


def test_synthetic_batches_equal_jax():
    for seed in (0, 3):
        for task, want in zip(("person_detection", "face_recognition", "pose_estimation"),
                              (jsynthetic.detection_batch, jsynthetic.face_batch,
                               jsynthetic.pose_batch)):
            got_loader = synthetic.make_loader(task, batches_per_epoch=2, seed=seed,
                                               batch_size=2, image_size=32)
            want_loader = jsynthetic.make_loader(task, batches_per_epoch=2, seed=seed,
                                                 batch_size=2, image_size=32)
            for g, w in zip(got_loader(1), want_loader(1), strict=True):
                assert g.keys() == w.keys()
                for k in g:
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (task, k)
        assert want is not None


def test_train_config_defaults_carry():
    assert dataclasses.asdict(train_config(pcfg)) == dataclasses.asdict(train_config(jcfg))


@pytest.mark.parametrize("norm", ["unit", "half", "imagenet", None])
def test_apply_image_norm_matches_jax(norm):
    """uint8 pixels through each task's normalisation within 1e-6; float
    pixels pass through."""
    from prpe_tpu.data.packed import apply_image_norm as japply
    from prpe_tpu_torch.data.packed import apply_image_norm

    img = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = apply_image_norm(torch.from_numpy(img), norm)
    want = np.asarray(japply(jnp.asarray(img), norm))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    x = torch.rand(2, 4, 4, 3)
    assert apply_image_norm(x, norm) is x
