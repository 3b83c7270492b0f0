"""The port's eval step of each task against the JAX package's on the CPU,
in fp32, from the same JAX variable tree and batch (the tiny combined
configuration of ``tests/test_torch_train.py``).

Eval mode runs the folded BatchNorms on running statistics, so both sides
are well conditioned. Tolerances: metrics within 1e-4 of their magnitude
(at least 1); detection boxes (in the image frame) and scores within 1e-4
of the largest; face embeddings and pose coordinates and scores within
1e-4; the valid detection masks and classes exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prpe_tpu.core import config as jcfg
from prpe_tpu.train import steps as jsteps
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.ops.kernels import _build
from prpe_tpu_torch.train.steps import make_eval_step
from test_torch_train import jax_variables, port_model, rel_err, task_batches, train_config
from torch_one_thread import torch_on_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def jax_evals():
    jm, v = jax_variables()
    batches = task_batches(seed=1)
    cfg = train_config(jcfg)
    variables = jax.tree_util.tree_map(jnp.asarray, v)
    out = {}
    for task in jcfg.TASKS:
        metrics, preds = jsteps.make_eval_step(jm, task, cfg)(
            variables, {k: jnp.asarray(a) for k, a in batches[task].items()})
        out[task] = (jax.device_get(metrics), jax.device_get(preds))
    return v, batches, out


def close(got, want, tol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("task", jcfg.TASKS)
def test_eval_step_matches_jax(jax_evals, task):
    v, batches, out = jax_evals
    want_metrics, want_preds = out[task]
    pm = port_model(v)
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    metrics, preds = make_eval_step(pm, task, train_config(pcfg))(batches[task])
    assert set(metrics) == set(want_metrics)
    for k, w in want_metrics.items():
        assert rel_err(metrics[k].numpy(), w) <= 1e-4, (k, float(metrics[k]), float(w))
    if task in ("person_detection", "face_detection"):
        assert np.array_equal(preds.valid.numpy(), np.asarray(want_preds.valid))
        assert preds.valid.any()
        valid = preds.valid.numpy()
        close(preds.boxes.numpy()[valid], np.asarray(want_preds.boxes)[valid])
        close(preds.scores.numpy()[valid], np.asarray(want_preds.scores)[valid])
        assert np.array_equal(preds.classes.numpy()[valid], np.asarray(want_preds.classes)[valid])
    elif task == "face_recognition":
        close(preds.numpy(), want_preds)
        assert {"loss_margin", "acc_margin"} <= set(metrics)
    else:
        coords, scores = preds
        close(coords.numpy(), want_preds[0])
        close(scores.numpy(), want_preds[1])
    # eval moves no statistic and no parameter
    for k, t in pm.state_dict().items():
        assert np.array_equal(t.numpy(), before[k].numpy()), k


def test_detection_eval_step_rescales_to_the_image_frame(jax_evals):
    """The step scales the boxes by image size / adapter size: declared at
    half the image size, the same network's boxes come out doubled."""
    v, batches, _ = jax_evals
    pm = port_model(v)
    cfg = train_config(pcfg)
    half = dataclasses.replace(cfg, detection=dataclasses.replace(cfg.detection,
                                                                  adapter_size=(32, 32)))
    batch = batches["person_detection"]
    _, dets = make_eval_step(pm, "person_detection", cfg)(batch)
    _, dets2 = make_eval_step(pm, "person_detection", half)(batch)
    assert dets.valid.any() and np.array_equal(dets.valid.numpy(), dets2.valid.numpy())
    np.testing.assert_array_equal(dets2.boxes.numpy(), dets.boxes.numpy() * 2.0)


def test_eval_step_counts_no_kernel_on_the_cpu(jax_evals):
    """On the CPU the wrappers take their plain versions and count nothing."""
    v, batches, _ = jax_evals
    pm = port_model(v)
    _build.reset_launches()
    make_eval_step(pm, "pose_estimation", train_config(pcfg))(batches["pose_estimation"])
    make_eval_step(pm, "person_detection", train_config(pcfg))(batches["person_detection"])
    assert not any(_build.launches.values())
