"""Shared body of ``tests/test_torch_parallel_jax*.py``: the port's train
step on a (dp, mp) mesh of gloo ranks against the JAX package's
single-device step, in fp32 (``tests/test_sharding.py:100-181``: one step at
any mesh gives the parameters of one step on the whole batch).

From ``tests/test_torch_train.py``'s numpy-filled JAX tree and batches
(detection and pose at batch 2, face at 8), branch scope, SGD at lr 0.1
without weight decay (the update is the gradient, element by element),
dropout off on both sides (the two draw different masks), at (dp, mp) =
(2, 1), (1, 2) and (2, 2). The bounds are ``tests/test_torch_train.py``'s:
each parameter's change within ``PARAM_TOL`` of the largest JAX change of
that tensor plus 1e-4 of the task's largest; metrics within 1e-4 of their
magnitude (at least 1), ``grad_norm`` within 5e-3; running statistics and
margin buffers within 1e-3. The ranks run while JAX compiles its steps.
"""

import flax.linen
import jax
import jax.numpy as jnp
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.train import optim as joptim
from prpe_tpu.train import state as jstate
from prpe_tpu.train import steps as jsteps
from prpe_tpu_torch.models.porting import from_jax_variables
from test_torch_train import PARAM_TOL, identity_dropout, jax_variables, task_batches

import torch_parallel_workers as W

OPTIM = dict(optimizer="sgd", learning_rate=0.1, weight_decay=0.0)
SHAPES = ((2, 1), (1, 2), (2, 2))
BOUNDS = dict(floor=1e-4, metric_tol=1e-4, norm_tol=5e-3, stat_tol=1e-3)


def runs(tasks, tmp_path_factory):
    """-> (the tree, JAX's step per task, shape -> rank 0's steps) for
    ``tasks``."""
    jm, v = jax_variables()
    batches = task_batches()
    state_dict = from_jax_variables(v)
    cases = [(task, torch.float32, False, "branch", None, None) for task in tasks]
    started = {}
    for shape in SHAPES:
        payload = dict(state_dict=state_dict, cfg_kwargs={}, batches=batches, optim=OPTIM,
                       cases=cases)
        started[shape] = W.Ranks(W.steps_worker, shape[0] * shape[1],
                                 str(tmp_path_factory.mktemp("mesh") / "init"), shape, payload)
    cfg = W.train_config(jcfg)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", identity_dropout)
        for task in tasks:
            tx = jsteps.mask_optimizer(
                joptim.build_optimizer(jcfg.OptimConfig(**OPTIM), v["params"]), task)
            state = jstate.create_train_state(jax.tree_util.tree_map(jnp.asarray, v),
                                              {task: tx})
            step = jsteps.make_train_step(jm, task, tx, cfg)
            new, metrics = step(state, {k: jnp.asarray(a) for k, a in batches[task].items()},
                                jax.random.key(1))
            after = from_jax_variables(jax.device_get(new.variables))
            want[task] = ({k: float(x) for k, x in jax.device_get(metrics).items()},
                          W.delta(after, state_dict))
    return state_dict, want, {shape: ranks.result() for shape, ranks in started.items()}


def check(runs, shape, task):
    state_dict, want, got = runs
    row = got[shape][(task, "float32", False, "branch")]
    assert row["ranks_equal"]
    worst = W.compare(row["delta"], state_dict, want[task][1], want[task][0], row["metrics"],
                      param_tol=PARAM_TOL[task], **BOUNDS)
    assert worst["metric_keys_equal"], (sorted(row["metrics"]), sorted(want[task][0]))
    for what in ("param", "stat", "metric"):
        assert worst[what] <= 1.0, (what, worst)
    # the frozen trunk's BatchNorms ran on the global batch's statistics
    assert "backbone.bn1.running_mean" in row["delta"]
