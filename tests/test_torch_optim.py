"""The port's schedules, optimizer chains and EMA against the JAX package's
(optax 0.2.6) on the CPU, in fp32.

Each schedule is read over its whole horizon. Each optimizer chain runs 5
updates (6 with accumulation) over the tiny combined model's parameters,
masked to one task as the trainer masks them, from the same gradients:
drawn from a seed, scaled so that the global-norm clip acts on some steps
and not on others. Tolerances: a schedule within 1e-6 of its peak; each
parameter's total change within 1e-4 of the largest JAX change of that
tensor plus 1e-6 of the learning rate plus two fp32 ulps of the
parameter; the EMA within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.train import optim as joptim
from prpe_tpu.train import state as jstate
from prpe_tpu.train import steps as jsteps
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.train import optim
from prpe_tpu_torch.train.state import update_ema
from prpe_tpu_torch.train.steps import TASK_BRANCHES, trainable_mask, trainable_params
from test_torch_train import jax_variables, port_model
from torch_one_thread import torch_on_one_thread  # noqa: F401

SCHEDULES = [
    dict(schedule="constant", learning_rate=3e-3),
    dict(schedule="linear", learning_rate=1e-2, warmup_steps=7, total_steps=40, min_lr=1e-5),
    dict(schedule="linear", learning_rate=1e-2, warmup_steps=0, total_steps=10),
    dict(schedule="cosine", learning_rate=2e-3, warmup_steps=5, total_steps=50, min_lr=1e-6),
    dict(schedule="onecycle", learning_rate=1e-3, warmup_steps=12, total_steps=60),
    dict(schedule="onecycle", learning_rate=1e-3, warmup_steps=0, total_steps=9),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: f"{kw['schedule']}-{kw.get('warmup_steps', 0)}")
def test_schedule_matches_optax(kw):
    got = optim.build_schedule(pcfg.OptimConfig(**kw))
    want = joptim.build_schedule(jcfg.OptimConfig(**kw))
    horizon = kw.get("total_steps", 20) + 5
    for count in range(horizon):
        w = float(np.asarray(want(jnp.asarray(count, jnp.int32))))
        assert abs(float(got(count)) - w) <= 1e-6 * kw["learning_rate"], (count, got(count), w)


def test_unknown_schedule_and_optimizer():
    with pytest.raises(ValueError, match="unknown schedule"):
        optim.build_schedule(pcfg.OptimConfig(schedule="step"))
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.build_optimizer(pcfg.OptimConfig(optimizer="lion"))


@pytest.fixture(scope="module")
def tree():
    _, v = jax_variables()
    return v, port_model(v)


def test_decay_mask_matches_jax(tree):
    v, pm = tree
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda m: np.float32(m), joptim._decay_mask(v["params"]))})
    got = {n: optim.decay_mask(n, p) for n, p in pm.named_parameters()}
    assert got == {n: bool(t.numpy()) for n, t in want.items()}
    assert any(got.values()) and not all(got.values())


CHAINS = [
    ("person_detection", dict(optimizer="adam", learning_rate=1e-3)),
    ("pose_estimation", dict(optimizer="adamw", learning_rate=1e-3, weight_decay=5e-2,
                             schedule="onecycle", warmup_steps=2, total_steps=5,
                             param_group_scales=(("vit_pose", 0.1),))),
    ("face_recognition", dict(optimizer="sgd", learning_rate=5e-2, weight_decay=5e-4,
                              schedule="linear", warmup_steps=2, total_steps=5)),
    ("face_detection", dict(optimizer="adam", learning_rate=1e-3, schedule="cosine",
                            warmup_steps=1, total_steps=4, accumulate=2, grad_clip_norm=3.0)),
]


@pytest.mark.parametrize("task,kw", CHAINS, ids=[c[1]["optimizer"] + "-" + c[0] for c in CHAINS])
def test_optimizer_chain_matches_optax(tree, task, kw):
    v, pm = tree
    params = {n: p.detach().clone() for n, p in trainable_params(pm, task).items()}
    start = {n: p.clone() for n, p in params.items()}
    tx = optim.build_optimizer(pcfg.OptimConfig(**kw))
    state = tx.init(params)

    jparams = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jtx = jsteps.mask_optimizer(joptim.build_optimizer(jcfg.OptimConfig(**kw), jparams), task)
    jstate_ = jax.jit(jtx.init)(jparams)
    jupdate = jax.jit(jtx.update)
    japply = jax.jit(optax.apply_updates)
    jmask = jsteps.trainable_mask(jparams, task)

    rng = np.random.default_rng(11)
    steps = 5 * max(1, kw.get("accumulate", 1)) + (1 if kw.get("accumulate") else 0)
    for i in range(steps):
        # global norms from about 0.5 to 50: the clip acts on some steps
        scale = 10.0 ** rng.uniform(-2.5, -0.5)
        # numpy leaves and jitted updates: no JAX op compiles per leaf shape
        jgrads = jax.tree_util.tree_map(
            lambda p, m: rng.normal(0, scale, p.shape).astype(np.float32) * np.float32(m),
            jparams, jmask)
        grads = from_jax_variables({"params": {k: jgrads[k] for k in TASK_BRANCHES[task]}})
        updates, state = tx.update(grads, state, params)
        params = {n: params[n] + updates[n] for n in params}
        jupdates, jstate_ = jupdate(jgrads, jstate_, jparams)
        jparams = japply(jparams, jupdates)

    want = from_jax_variables({"params": jax.device_get(jparams)})
    moved = 0
    for n, p in params.items():
        dw = want[n].numpy() - start[n].numpy()
        dg = p.numpy() - start[n].numpy()
        # plus two fp32 ulps of the parameter: each side rounds its sums
        tol = (1e-4 * float(np.abs(dw).max()) + 1e-6 * kw["learning_rate"]
               + 2.4e-7 * float(np.abs(start[n].numpy()).max()))
        assert float(np.abs(dg - dw).max()) <= tol, n
        moved += bool(np.abs(dw).max() > 0)
    assert moved == len(params)
    # the frozen parameters are in no optimizer state
    before = from_jax_variables(v)
    for n, m in trainable_mask(pm, task).items():
        if not m:
            assert np.array_equal(want[n].numpy(), before[n].numpy())


@pytest.mark.parametrize("norm", [0.5, 10.0, 40.0])
def test_clip_by_global_norm_matches_optax(norm):
    rng = np.random.default_rng(12)
    g = {"a": rng.normal(size=(3, 5)), "b": rng.normal(size=(7,))}
    total = np.sqrt(sum((x ** 2).sum() for x in g.values()))
    g = {k: (x * norm / total).astype(np.float32) for k, x in g.items()}
    got, _ = optim.clip_by_global_norm(10.0).update({k: torch.from_numpy(x) for k, x in g.items()},
                                                    (), None)
    want, _ = optax.clip_by_global_norm(10.0).update(
        {k: jnp.asarray(x) for k, x in g.items()}, optax.EmptyState())
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("updates", [1, 10, 1000])
def test_update_ema_matches_jax(updates):
    rng = np.random.default_rng(13)
    ema = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=(3,)).astype(np.float32)}
    p = {k: (x + rng.normal(size=x.shape)).astype(np.float32) for k, x in ema.items()}
    got = {k: torch.from_numpy(x.copy()) for k, x in ema.items()}
    update_ema(got, {k: torch.from_numpy(x) for k, x in p.items()}, updates, decay=0.999, tau=20.0)
    want = jstate.update_ema({k: jnp.asarray(x) for k, x in ema.items()},
                             {k: jnp.asarray(x) for k, x in p.items()},
                             jnp.asarray(updates, jnp.int32), decay=0.999, tau=20.0)
    for k in ema:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)
