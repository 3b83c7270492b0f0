"""The port's round-robin training against the JAX package's over many steps,
on the CPU: the two trainers' step functions (not the CLIs), from one
numpy-filled JAX variable tree carried across by ``from_jax_variables``,
over the same numpy batches.

The tiny preset of ``chip_smoke.py::tiny_combined_config`` (a (1, 1, 1, 1)
trunk, IR-18 on 32^2 with 10 classes, a 1-layer ViT of width 32 at 64x48;
the detection adapters at 64^2, see ``model_config``) trains the four tasks round-robin, 3
cycles of 4 steps a task, each task with the optimizer ``cli/train.py``
gives it (``prpe_tpu/cli/train.py:300-324``,
``prpe_tpu_torch/cli/train.py:363-381``): lr 1e-3, Adam for detection and
face recognition, AdamW with the one-cycle schedule and the ViT at 0.1x for
pose, ``total_steps`` = 12 a task and ``warmup_steps`` = 12 // 5 = 2, so
the warm-up and the anneal both fall inside the run. Dropout is off on
both sides (flax's ``Dropout`` replaced while the JAX steps trace, the
port's rate 0): the two draw different masks.

The trajectory runs in fp32, and its pose steps again with the bf16
compute policy (fp32 parameters, bf16 activations) against JAX's bf16
step: the other tasks' steps move neither pose's parameters nor anything
a train-mode pose step reads. JAX's fp32 and bf16 runs side by side give
the distance bf16 alone puts between two runs.
After every step each test compares the whole state dict (every parameter
and every BatchNorm statistic, the frozen trunk's included, which every
task's step moves), the stepping task's Adam moments, update count and
learning rate, and the step's metrics.

What is held, and how tightly:

- **Exactly**: the frozen trunk's parameters (no task moves them); every
  task's update count. The learning rate of each task at each step, the
  port's schedule against optax's, within 1e-6 of the peak as in
  ``tests/test_torch_optim.py`` (optax's one-cycle subtracts in fp32 and is
  off by 7e-11 at the first step).
- **The trunk's running statistics** (they depend on the frozen trunk and
  the batches only): fp32 within 1e-4 of their magnitude (at least 1)
  (measured 3.3e-6), bf16 within 5e-2 (1.6e-2).
- **Pose in fp32**, the task the port's 60-epoch run left behind: each
  parameter's distance to JAX's (root mean square over the tensor) within
  ``POSE_TOL`` of the root mean square of JAX's change of that tensor since
  the start (the maximum would count the entries whose gradient is near
  zero, which Adam's first steps move by lr x sign(g) in either
  direction), the adapter's running statistics within ``POSE_STATS_TOL`` of
  their magnitude (at least 1; a running mean also gets the drift of the
  conv bias in front of it, below), the Adam moments within
  ``POSE_MOMENT_TOL`` of the task's largest, the loss terms and the
  gradient norm within ``POSE_METRIC_TOL`` relative. At this size each
  framework's rounding grows through the adapter's BatchNorms over 16
  values a channel: the distances grow over the run to the measured
  maxima beside the tolerances, with no leaf apart. Two kinds of leaf have a
  gradient that is zero in exact arithmetic (a conv bias in front of a
  train-mode BatchNorm, the attention's key bias under the softmax), so
  each framework's fp32 rounding gives them a noise gradient that Adam
  turns into a step of about lr: they are held to ``ADAM_BOUND`` x 2 x the
  sum of the learning rates they saw (with the ViT's 0.1x).
- **Detection and face recognition**: from random weights at this size
  they are chaotic in fp32 (BatchNorms over 4-16 values per channel, and
  Adam's first steps are lr x sign(g), so gradient entries near zero flip):
  by their third step the two frameworks' gradient norms differ up to
  threefold. Their first step's Adam first moment (0.1 x the gradient) is held
  within ``FIRST_MOMENT_TOL`` of the task's largest entry, as
  ``tests/test_torch_train.py`` holds the gradients, and its loss within
  3e-2 relative;
  after that each parameter stays within Adam's step bound of JAX's
  (``ADAM_BOUND`` x 2 x the sum of the learning rates), which a wrong
  learning rate, schedule or update would break.
- **bf16**: every tensor in the dtype JAX gives it at the rounding points:
  bf16 heatmaps out of the head, an fp32 loss, fp32 updates and Adam
  moments, fp32 parameters and statistics. At this size bf16 moves one
  pose step's loss by up to 3 % in either framework, so each quantity is
  held to ``BF16_FACTOR`` x the distance between JAX's own bf16 and fp32
  runs at the same step (plus a floor): the pose loss and parameters.
"""

import copy
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.models.combined import CombinedModel as JCombinedModel
from prpe_tpu.train import optim as joptim
from prpe_tpu.train import state as jstate
from prpe_tpu.train import steps as jsteps
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.data import synthetic
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.train import optim as poptim
from prpe_tpu_torch.train.state import create_train_state
from prpe_tpu_torch.train.steps import TASK_BRANCHES, make_train_step, trainable_params
from test_torch_models import random_variables
from torch_one_thread import torch_on_one_thread  # noqa: F401

CYCLES, STEPS = 3, 4
TOTAL = CYCLES * STEPS  # steps of each task
LR = 1e-3
TASKS = jcfg.TASKS
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# measured maxima over the run in brackets
POSE_TOL = 5e-2  # (1.5e-2)
POSE_STATS_TOL = 5e-2  # (1.2e-2)
POSE_MOMENT_TOL = 0.15  # (5.4e-2)
POSE_METRIC_TOL = {"loss": 3e-2, "heatmap_loss": 3e-2, "oks_loss": 3e-2,  # (9.9e-3)
                   "grad_norm": 0.2}  # (7.4e-2); pck and pck_px within 2 of 68 keypoints
FIRST_MOMENT_TOL = 5e-2  # (2.7e-2)
ADAM_BOUND = 2.0  # (1.0)
BF16_FACTOR = 3.0  # (1.5)


def model_config(m):
    """``chip_smoke.py::tiny_combined_config`` in package ``m``, with the
    detection adapters at 64^2 as in ``tests/test_torch_train.py``: at 32^2
    the YOLOs' deepest BatchNorms see 2 values a channel, and the first
    gradients are rounding noise in either framework."""
    return m.CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1), detection=m.DetectionConfig(adapter_size=(64, 64)),
        face=m.AdaFaceConfig(arch="ir_18", num_classes=10, input_size=(32, 32)),
        pose=m.PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                          vit_layers=1, vit_heads=2))


def task_configs(m):
    """``default_task_configs()`` as both CLIs finish them: the CLI's lr, the
    horizon, warm-up min(1000, total // 5) unless the schedule is constant."""
    return tuple(dataclasses.replace(t, optim=dataclasses.replace(
        t.optim, learning_rate=LR, total_steps=TOTAL,
        warmup_steps=min(1000, TOTAL // 5) if t.optim.schedule != "constant" else 0))
        for t in m.default_task_configs())


def schedule_of(tasks):
    """The round-robin order and its numpy batches (seed 0)."""
    rng = np.random.default_rng(0)
    make = {"person_detection": lambda: synthetic.detection_batch(rng, 2, 64, 4),
            "face_detection": lambda: synthetic.detection_batch(rng, 2, 64, 4),
            "face_recognition": lambda: synthetic.face_batch(rng, 8, 64, 10),
            "pose_estimation": lambda: synthetic.pose_batch(rng, 4, 64, 3)}
    return [(t, make[t]()) for _ in range(CYCLES) for t in tasks for _ in range(STEPS)]


def identity_dropout(rate, deterministic=None, **kw):
    return lambda x, *a, **k: x


def find_adam(state):
    """The ``ScaleByAdamState`` inside an optax state."""
    if isinstance(state, optax.ScaleByAdamState):
        return state
    inner = getattr(state, "inner_state", None)
    children = [inner] if inner is not None else (
        list(state) if isinstance(state, (tuple, list)) else [])
    for s in children:
        found = find_adam(s)
        if found is not None:
            return found
    return None


def find_port_adam(state):
    """The Adam dict (count, mu, nu) inside a port optimizer state."""
    if isinstance(state, dict) and "mu" in state:
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = find_port_adam(s)
            if found is not None:
                return found
    return None


def jax_moments(adam, task):
    """mu, nu of a masked optax Adam state over ``task``'s branch, as
    port-named numpy arrays."""
    def branch(tree):
        return {"params": {k: jax.device_get(tree[k]) for k in TASK_BRANCHES[task]}}
    return ({k: v.numpy() for k, v in from_jax_variables(branch(adam.mu)).items()},
            {k: v.numpy() for k, v in from_jax_variables(branch(adam.nu)).items()})


def owner(name: str):
    """The task whose optimizer trains parameter ``name`` (None: the trunk)."""
    top = name.split(".")[0]
    return next((t for t, keys in TASK_BRANCHES.items() if top in keys), None)


def gradient_free(name: str, names) -> bool:
    """A leaf whose gradient is zero in exact arithmetic: a conv bias in
    front of a train-mode BatchNorm, or the attention's key bias."""
    if name.endswith("attn.k.bias"):
        return True
    if name.endswith(".conv.bias"):
        return name[:-len("conv.bias")] + "bn.running_mean" in names
    return False


class Lane:
    """One framework's trainer in one dtype."""

    def __init__(self, kind, dtype, variables, tasks):
        self.kind = kind
        if kind == "jax":
            self.model = JCombinedModel(config=model_config(jcfg), dtype=DTYPES[dtype][0])
            self.tx = {t.name: jsteps.mask_optimizer(
                joptim.build_optimizer(t.optim, variables["params"]), t.name) for t in tasks}
            self.state = jstate.create_train_state(
                jax.tree_util.tree_map(jnp.asarray, variables), self.tx)
            self.steps = {t.name: jsteps.make_train_step(self.model, t.name, self.tx[t.name],
                                                         model_config(jcfg))
                          for t in tasks if t.name != "face_detection"}
            # one compiled program for both detection tasks, as the JAX
            # trainer shares it (their optimizers are the same)
            self.steps["face_detection"] = jsteps.make_shared_detection_train_step(
                self.steps["person_detection"])
        else:
            self.model = CombinedModel(model_config(pcfg), DTYPES[dtype][1], device="cpu")
            self.model.load_state_dict(from_jax_variables(variables), strict=True)
            self.model.ada_face.dropout.rate = 0.0
            self.tx = {t.name: poptim.build_optimizer(t.optim) for t in tasks}
            self.state = create_train_state(
                self.model, self.tx, {t.name: trainable_params(self.model, t.name)
                                      for t in tasks})
            self.steps = {t.name: make_train_step(self.model, t.name, self.tx[t.name],
                                                  model_config(pcfg)) for t in tasks}

    def step(self, task, batch, i):
        if self.kind == "jax":
            self.state, m = self.steps[task](
                self.state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(i))
            return {k: float(v) for k, v in jax.device_get(m).items()}
        self.state, m = self.steps[task](self.state, batch)
        return {k: float(v) for k, v in m.items()}

    def state_dict(self):
        if self.kind == "jax":
            return {k: v.numpy() for k, v in from_jax_variables(
                jax.device_get(self.state.variables)).items()}
        return {k: v.detach().float().numpy().copy() for k, v in self.model.state_dict().items()}

    def moments(self, task):
        """(count, mu, nu) of ``task``'s Adam."""
        if self.kind == "jax":
            adam = find_adam(self.state.opt_states[task])
            return (int(adam.count),) + jax_moments(adam, task)
        adam = find_port_adam(self.state.opt_states[task])
        return (adam["count"], {k: v.float().numpy() for k, v in adam["mu"].items()},
                {k: v.float().numpy() for k, v in adam["nu"].items()})


def maxabs(a, b=None):
    return float(np.abs(a if b is None else a - b).max()) if np.size(a) else 0.0


def run_trajectories():
    """Every lane through the round-robin; returns per-step records of the
    measured distances and the facts the tests check."""
    jm = JCombinedModel(config=model_config(jcfg))
    variables = random_variables(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,), jnp.int32),
        method="init_all"))
    variables["batch_stats"]["margin_mean"] = np.float32(30.0)
    variables["batch_stats"]["margin_std"] = np.float32(20.0)
    jtasks, ptasks = task_configs(jcfg), task_configs(pcfg)
    schedules = {t.name: (joptim.build_schedule(t.optim), poptim.build_schedule(t.optim))
                 for t in jtasks}
    scales = {t.name: dict(t.optim.param_group_scales) for t in jtasks}
    init = {k: v.numpy() for k, v in from_jax_variables(variables).items()}
    names = set(init)
    records = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", identity_dropout)
        lanes = {(kind, dt): Lane(kind, dt, variables, jtasks if kind == "jax" else ptasks)
                 for dt in DTYPES for kind in ("jax", "port")}
        params = {n for n, _ in lanes[("port", "float32")].model.named_parameters()}
        dtypes = _rounding_points(lanes)
        done = dict.fromkeys(TASKS, 0)
        lr_sum = dict.fromkeys(TASKS, 0.0)  # sum of the learning rates applied so far
        for i, (task, batch) in enumerate(schedule_of(TASKS)):
            lr_j = float(schedules[task][0](done[task]))
            lr_p = float(schedules[task][1](done[task]))
            done[task] += 1
            lr_sum[task] += lr_j
            # the bf16 lanes take the pose steps only: the other tasks move
            # neither pose's parameters nor anything a train-mode pose step reads
            stepping = {key: lane for key, lane in lanes.items()
                        if key[1] == "float32" or task == "pose_estimation"}
            metrics = {key: lane.step(task, batch, i) for key, lane in stepping.items()}
            sds = {key: lane.state_dict() for key, lane in stepping.items()}
            moments = {key: lane.moments(task) for key, lane in stepping.items()}
            rec = {"i": i, "task": task, "n": done[task], "lr": (lr_j, lr_p),
                   "metrics": metrics, "counts": {k: m[0] for k, m in moments.items()},
                   "first": done[task] == 1}
            for dt in {key[1] for key in stepping}:
                rec[dt] = _distances(dt, task, sds, moments, init, names, lr_sum, scales, params,
                                     rec["first"])
            records.append(rec)
    return records, dtypes


def _rounding_points(lanes):
    """The dtypes of the bf16 lanes at the head, the loss, the update and
    the Adam moments (one pose step's worth, on copies)."""
    from prpe_tpu_torch.train.steps import make_loss_fn, to_device

    batch = synthetic.pose_batch(np.random.default_rng(9), 2, 64, 3)
    out = {}
    jlane, plane = lanes[("jax", "bfloat16")], lanes[("port", "bfloat16")]
    loss_fn = jsteps.make_loss_fn(jlane.model, "pose_estimation", model_config(jcfg))
    tx = jlane.tx["pose_estimation"]

    def one_step(state, batch):
        hm = jlane.model.apply(state.variables, batch["image"], method="pose")
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, batch, jax.random.key(0), True)
        updates, opt = tx.update(grads, state.opt_states["pose_estimation"], state.params)
        return hm, loss, updates["vit_pose"], find_adam(opt).mu["vit_pose"], state.params

    # dtypes only: traced, not run
    hm, loss, updates, mu, jparams = jax.eval_shape(
        one_step, jlane.state, {k: jnp.asarray(v) for k, v in batch.items()})
    leaf = lambda tree: jax.tree_util.tree_leaves(tree)[0].dtype  # noqa: E731
    out["jax"] = {"heatmaps": str(hm.dtype), "loss": str(loss.dtype),
                  "update": str(leaf(updates)), "mu": str(leaf(mu)),
                  "param": str(leaf(jparams["vit_pose"]))}
    model = copy.deepcopy(plane.model)  # the step moves BatchNorm statistics
    with torch.no_grad():
        phm = model.pose(torch.as_tensor(batch["image"]))
    ploss, _ = make_loss_fn(model, "pose_estimation", model_config(pcfg))(
        to_device(batch, "cpu"), True)
    params = trainable_params(model, "pose_estimation")
    g = torch.autograd.grad(ploss, list(params.values()), allow_unused=True)
    g = {n: (torch.zeros_like(p) if x is None else x) for (n, p), x in zip(params.items(), g)}
    tx = plane.tx["pose_estimation"]
    upd, st = tx.update(g, tx.init(dict(params)), dict(params))
    first = next(n for n in params if n.startswith("vit_pose."))
    out["port"] = {"heatmaps": str(phm.dtype).replace("torch.", ""),
                   "loss": str(ploss.dtype).replace("torch.", ""),
                   "update": str(upd[first].dtype).replace("torch.", ""),
                   "mu": str(find_port_adam(st)["mu"][first].dtype).replace("torch.", ""),
                   "param": str(params[first].dtype).replace("torch.", "")}
    return out


def _distances(dt, task, sds, moments, init, names, lr_sum, scales, params, first):
    """The distances one step leaves, per group of leaves (``names``: every
    state-dict entry, ``params``: the parameters among them)."""
    jsd, psd = sds[("jax", dt)], sds[("port", dt)]
    ref = sds[("jax", "float32")]
    out = {"trunk_params_equal": all(np.array_equal(psd[k], jsd[k]) and np.array_equal(
        psd[k], init[k]) for k in params if k.startswith("backbone."))}
    stats = [k for k in names if k.startswith("backbone.") and "running" in k]
    out["trunk_stats"] = max(maxabs(psd[k], jsd[k]) / max(1.0, maxabs(jsd[k])) for k in stats)
    tight, free, stats_err, bound_ratio = 0.0, 0.0, 0.0, 0.0
    pose_ref = 0.0
    for k in names:
        t = owner(k)
        if t is None:
            continue
        scale = scales[t].get(k.split(".")[0], 1.0)
        budget = 2.0 * lr_sum[t] * scale
        d = maxabs(psd[k], jsd[k])
        is_param = k in params
        if t == "pose_estimation" and dt == "float32":
            if is_param and not gradient_free(k, names):
                dj = jsd[k] - init[k]
                rms = float(np.sqrt(np.mean((psd[k] - jsd[k]) ** 2)))
                tight = max(tight, rms / max(float(np.sqrt(np.mean(dj ** 2))), 1e-30))
            elif is_param:
                free = max(free, d / max(budget, 1e-30))
            elif "running_mean" in k or "running_var" in k:
                # a running mean follows the drift of the conv bias in front
                bias = k.rsplit(".", 2)[0] + ".conv.bias"
                extra = ADAM_BOUND * budget if k.endswith("mean") and bias in names else 0.0
                stats_err = max(stats_err, (d - extra) / max(1.0, maxabs(jsd[k])))
        elif t == "pose_estimation" and is_param:
            pose_ref = max(pose_ref, maxabs(jsd[k], ref[k]))
            tight = max(tight, d)
        elif is_param and lr_sum[t] > 0:
            bound_ratio = max(bound_ratio, d / budget)
    out.update(pose_tight=tight, pose_free=free, pose_stats=stats_err, pose_ref=pose_ref,
               chaotic_bound=bound_ratio)
    (jc, jmu, jnu), (pc, pmu, pnu) = moments[("jax", dt)], moments[("port", dt)]
    out["counts"] = (jc, pc)
    if task == "pose_estimation":
        top_mu = max(maxabs(jmu[k]) for k in pmu)
        top_nu = max(maxabs(jnu[k]) for k in pnu)
        free_names = [k for k in pmu if gradient_free(k, names)]
        out["pose_mu"] = max(maxabs(pmu[k], jmu[k]) for k in pmu if k not in free_names) / top_mu
        out["pose_nu"] = max(maxabs(pnu[k], jnu[k]) for k in pnu if k not in free_names) / top_nu
    elif first:
        top = max(maxabs(jmu[k]) for k in pmu)
        out["first_mu"] = max(maxabs(pmu[k], jmu[k]) for k in pmu) / top
    return out


@pytest.fixture(scope="module")
def trajectories():
    return run_trajectories()


def test_counts_and_learning_rates(trajectories):
    records, _ = trajectories
    for r in records:
        lr_j, lr_p = r["lr"]
        assert abs(lr_p - lr_j) <= 1e-6 * LR, (r["i"], lr_p, lr_j)
        for dt in DTYPES:
            if dt in r:
                assert r[dt]["counts"] == (r["n"], r["n"]), (r["i"], dt, r[dt]["counts"])
    pose = [r["lr"][0] for r in records if r["task"] == "pose_estimation"]
    peak = int(np.argmax(pose))
    # the warm-up rises to the peak and the anneal falls after it, inside the run
    assert 0 < peak < len(pose) - 1
    assert all(a < b for a, b in zip(pose[:peak], pose[1:peak + 1]))
    assert all(a > b for a, b in zip(pose[peak:], pose[peak + 1:]))
    assert pose[-1] < 0.05 * max(pose)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_frozen_trunk(trajectories, dtype):
    records, _ = trajectories
    tol = 1e-4 if dtype == "float32" else 5e-2
    for r in (r for r in records if dtype in r):
        assert r[dtype]["trunk_params_equal"], (r["i"], r["task"])
        assert r[dtype]["trunk_stats"] <= tol, (r["i"], r["task"], r[dtype]["trunk_stats"])


def test_pose_fp32(trajectories):
    records, _ = trajectories
    for r in records:
        d = r["float32"]
        assert d["pose_tight"] <= POSE_TOL, (r["i"], r["task"], d["pose_tight"])
        assert d["pose_free"] <= ADAM_BOUND, (r["i"], r["task"], d["pose_free"])
        assert d["pose_stats"] <= POSE_STATS_TOL, (r["i"], r["task"], d["pose_stats"])
        if r["task"] == "pose_estimation":
            assert d["pose_mu"] <= POSE_MOMENT_TOL and d["pose_nu"] <= POSE_MOMENT_TOL, r["i"]
            got, want = r["metrics"][("port", "float32")], r["metrics"][("jax", "float32")]
            assert set(got) == set(want)
            for k, w in want.items():
                tol = POSE_METRIC_TOL[k] * abs(w) if k in POSE_METRIC_TOL else 2 / 68
                assert abs(got[k] - w) <= tol, (r["i"], k, got[k], w)


def test_detection_and_face_fp32(trajectories):
    records, _ = trajectories
    for r in records:
        d = r["float32"]
        assert d["chaotic_bound"] <= ADAM_BOUND, (r["i"], r["task"], d["chaotic_bound"])
        if r["first"] and r["task"] != "pose_estimation":
            assert d["first_mu"] <= FIRST_MOMENT_TOL, (r["task"], d["first_mu"])
            got, want = r["metrics"][("port", "float32")], r["metrics"][("jax", "float32")]
            assert abs(got["loss"] - want["loss"]) <= 3e-2 * abs(want["loss"]), r["task"]
        for v in r["metrics"][("port", "float32")].values():
            assert np.isfinite(v)


def test_bf16_rounding_points(trajectories):
    _, dtypes = trajectories
    want = {"heatmaps": "bfloat16", "loss": "float32", "update": "float32", "mu": "float32",
            "param": "float32"}
    assert dtypes["jax"] == want
    assert dtypes["port"] == want


def test_pose_bf16(trajectories):
    """The port's bf16 pose trajectory is as close to JAX's bf16 one as
    JAX's bf16 run is to its own fp32 run, step by step."""
    records, _ = trajectories
    for r in (r for r in records if "bfloat16" in r):
        d = r["bfloat16"]
        assert d["chaotic_bound"] <= ADAM_BOUND, (r["i"], r["task"], d["chaotic_bound"])
        assert d["pose_tight"] <= BF16_FACTOR * d["pose_ref"] + 1e-3 * LR, (
            r["i"], r["task"], d["pose_tight"], d["pose_ref"])
        if r["task"] == "pose_estimation":
            got = r["metrics"][("port", "bfloat16")]["loss"]
            want = r["metrics"][("jax", "bfloat16")]["loss"]
            ref = r["metrics"][("jax", "float32")]["loss"]
            assert abs(got - want) <= BF16_FACTOR * abs(want - ref) + 1e-2 * abs(want), (
                r["i"], got, want, ref)
