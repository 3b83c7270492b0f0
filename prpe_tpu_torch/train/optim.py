"""Optimizers and learning-rate schedules (``prpe_tpu/train/optim.py``), with
optax 0.2.6's semantics.

An optimizer here is a ``Transform``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)`` over dicts of named
tensors, composed as optax composes its transformations; the caller adds
the updates to the parameters. Where optax and ``torch.optim`` differ, the
optax behaviour is kept:

* ``clip_by_global_norm`` scales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon, over the parameters it is given
  (a task's trainable ones; under a mesh the norm of the whole split
  parameters, ``parallel/mesh.py::global_norm``);
* a schedule is read at the update count before its increment;
* the one-cycle schedule is optax's cosine one-cycle, not ``OneCycleLR``;
* ``param_group_scales`` scales the whole update after the optimizer,
  weight decay included;
* ``accumulate > 1`` averages that many gradients per update (optax
  ``MultiSteps``).

Adam/AdamW (with the decay mask: no decay on biases, norm scales, PReLU
slopes or 1-d parameters) and SGD with Nesterov momentum 0.937.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from prpe_tpu_torch.core.config import OptimConfig

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class Transform(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Tuple[Params, Any]]


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def _no_state(params):
    return ()


def sum_of_squares(t: torch.Tensor) -> torch.Tensor:
    """Sum of the squares of ``t``'s elements in fp32 at least (float64
    stays float64)."""
    t = t.to(torch.promote_types(t.dtype, torch.float32))
    return (t * t).sum()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (fp32 scalar; float64
    for float64 tensors)."""
    tensors = list(tensors)
    return torch.stack([sum_of_squares(t) for t in tensors]).sum().sqrt()


def clip_by_global_norm(max_norm: float, norm_fn: Optional[Callable[[Params], torch.Tensor]]
                        = None) -> Transform:
    """``norm_fn(named updates)`` gives the norm (default: ``global_norm`` of
    the tensors as they are)."""
    def update(updates, state, params):
        norm = norm_fn(updates) if norm_fn is not None else global_norm(updates.values())
        keep = norm < max_norm
        return {n: torch.where(keep, u, u / norm.to(u.dtype) * max_norm)
                for n, u in updates.items()}, state

    return Transform(_no_state, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params):
        names = list(updates)
        g = [updates[n] for n in names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul([state["mu"][n] for n in names], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul([state["nu"][n] for n in names], b2))
        count = state["count"] + 1
        # 1 - b^count in fp32, as optax's bias correction
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        out = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        return (dict(zip(names, out)),
                {"count": count, "mu": dict(zip(names, mu)), "nu": dict(zip(names, nu))})

    return Transform(init, update)


def add_decayed_weights(weight_decay: float, mask: Callable[[str, torch.Tensor], bool]) -> Transform:
    def update(updates, state, params):
        return {n: (u + weight_decay * params[n] if mask(n, params[n]) else u)
                for n, u in updates.items()}, state

    return Transform(_no_state, update)


def trace(decay: float, nesterov: bool = False) -> Transform:
    def init(params):
        return {n: torch.zeros_like(p) for n, p in params.items()}

    def update(updates, state, params):
        new_trace = {n: u + decay * state[n] for n, u in updates.items()}
        if nesterov:
            updates = {n: u + decay * new_trace[n] for n, u in updates.items()}
        else:
            updates = dict(new_trace)
        return updates, new_trace

    return Transform(init, update)


def scale_by_learning_rate(schedule: Schedule) -> Transform:
    """Multiply by -schedule(count); count starts at 0."""
    def update(updates, state, params):
        lr = -float(np.float32(schedule(state)))
        names = list(updates)
        return dict(zip(names, torch._foreach_mul([updates[n] for n in names], lr))), state + 1

    return Transform(lambda params: 0, update)


def scale_subtree(name: str, factor: float) -> Transform:
    """Multiply the updates of the top-level parameter subtree ``name``."""
    def update(updates, state, params):
        return {n: (u * factor if n.split(".")[0] == name else u)
                for n, u in updates.items()}, state

    return Transform(_no_state, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """optax ``MultiSteps``: the running mean of ``every_k`` gradients goes
    through ``inner`` on every ``every_k``-th call; the other calls return
    zero updates and leave ``inner``'s state as it was."""
    def init(params):
        return {"mini_step": 0, "inner": inner.init(params),
                "acc": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(updates, state, params):
        n_acc = state["mini_step"]
        acc = {n: a + (updates[n] - a) / (n_acc + 1) for n, a in state["acc"].items()}
        if n_acc == every_k - 1:
            out, inner_state = inner.update(acc, state["inner"], params)
            return out, {"mini_step": 0, "inner": inner_state,
                         "acc": {n: torch.zeros_like(a) for n, a in acc.items()}}
        return ({n: torch.zeros_like(u) for n, u in updates.items()},
                {"mini_step": n_acc + 1, "inner": state["inner"], "acc": acc})

    return Transform(init, update)


# ------------------------------------------------------------------ schedules

def _linear(init_value: float, end_value: float, steps: int) -> Schedule:
    """optax ``linear_schedule`` (polynomial of power 1), in fp32."""
    if steps <= 0:
        return lambda count: init_value
    f32 = np.float32

    def schedule(count):
        c = f32(min(max(count, 0), steps))
        frac = f32(1) - c / f32(steps)
        return f32(init_value - end_value) * frac + f32(end_value)

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule`` (exponent 1), in fp32."""
    f32 = np.float32

    def schedule(count):
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha))

    return schedule


def _join(schedules, boundaries) -> Schedule:
    """optax ``join_schedules``: the i-th schedule from the i-th boundary on,
    read at the count since that boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def _cosine_onecycle(transition_steps: int, peak_value: float, pct_start: float,
                     div_factor: float, final_div_factor: float) -> Schedule:
    """optax ``cosine_onecycle_schedule``: from peak / div_factor up to the
    peak at ``pct_start`` of the way by a half cosine, then down to
    peak / (div_factor * final_div_factor) at ``transition_steps``."""
    init = peak_value / div_factor
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)])
    values = np.cumprod([init, div_factor, 1.0 / (div_factor * final_div_factor)])
    f32 = np.float32

    def schedule(count):
        total = f32(0)
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = f32(count - bounds[i]) / f32(bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                total = f32(end + (start - end) / 2.0 * (np.cos(f32(math.pi) * pct) + f32(1)))
        return total + (f32(values[-1]) if count >= bounds[-1] else f32(0))

    return schedule


def build_schedule(cfg: OptimConfig) -> Schedule:
    if cfg.schedule == "constant":
        return lambda count: cfg.learning_rate
    warmup = max(cfg.warmup_steps, 1)
    decay = max(cfg.total_steps - warmup, 1)
    if cfg.schedule == "linear":
        return _join([_linear(cfg.min_lr, cfg.learning_rate, warmup),
                      _linear(cfg.learning_rate, cfg.min_lr, decay)], [warmup])
    if cfg.schedule == "cosine":
        if cfg.total_steps - warmup <= 0:
            raise ValueError("cosine schedule needs total_steps > warmup_steps")
        alpha = 0.0 if cfg.learning_rate == 0.0 else cfg.min_lr / cfg.learning_rate
        return _join([_linear(cfg.min_lr, cfg.learning_rate, warmup),
                      _cosine_decay(cfg.learning_rate, cfg.total_steps - warmup, alpha)], [warmup])
    if cfg.schedule == "onecycle":
        return _cosine_onecycle(cfg.total_steps, cfg.learning_rate,
                                warmup / max(cfg.total_steps, 1), 25.0, 1e4)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


# ----------------------------------------------------------------- optimizers

def decay_mask(name: str, param: torch.Tensor) -> bool:
    """True where weight decay applies: not on biases, norm scales or PReLU
    slopes (by leaf or module name, the flax names), nor on any parameter
    of fewer than 2 dims."""
    parts = name.split(".")
    if parts[-1] in ("bias", "scale", "alpha"):
        return False
    if any(p.startswith("bn") or "norm" in p.lower() or p.startswith("ln") for p in parts[:-1]):
        return False
    return param.dim() > 1


def build_optimizer(cfg: OptimConfig, norm_fn: Optional[Callable[[Params], torch.Tensor]] = None
                    ) -> Transform:
    """clip by global norm -> Adam / AdamW / SGD-Nesterov -> the per-group
    scales, accumulated over ``cfg.accumulate`` calls. ``norm_fn`` computes
    the clip's norm (a mesh's, over split parameters)."""
    schedule = build_schedule(cfg)
    if cfg.optimizer == "adam":
        core = chain(scale_by_adam(), scale_by_learning_rate(schedule))
    elif cfg.optimizer == "adamw":
        core = chain(scale_by_adam(), add_decayed_weights(cfg.weight_decay, decay_mask),
                     scale_by_learning_rate(schedule))
    elif cfg.optimizer == "sgd":
        core = chain(add_decayed_weights(cfg.weight_decay, decay_mask),
                     trace(0.937, nesterov=True), scale_by_learning_rate(schedule))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    tx = chain(clip_by_global_norm(cfg.grad_clip_norm, norm_fn), core,
               *(scale_subtree(name, s) for name, s in cfg.param_group_scales))
    if cfg.accumulate > 1:
        tx = multi_steps(tx, cfg.accumulate)
    return tx
