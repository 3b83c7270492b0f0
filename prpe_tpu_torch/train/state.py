"""Train state (``prpe_tpu/train/state.py``).

The parameters and BatchNorm statistics live in the model. ``TrainState``
holds what the JAX package's state holds besides them: the global step,
one optimizer state per task (each over that task's trainable parameters),
and the EMA of the parameters with its update count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn


@dataclass
class TrainState:
    step: int = 0
    opt_states: Dict[str, Any] = field(default_factory=dict)
    ema_params: Optional[Dict[str, torch.Tensor]] = None
    ema_updates: int = 0


def create_train_state(model: nn.Module, optimizers: Mapping[str, Any],
                       trainable: Mapping[str, Mapping[str, torch.Tensor]],
                       use_ema: bool = False) -> TrainState:
    """``optimizers`` and ``trainable`` (the named parameters each task's
    optimizer covers) keyed by task; the EMA, if used, starts as a copy of
    every parameter."""
    ema = None
    if use_ema:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(opt_states={t: tx.init(dict(trainable[t])) for t, tx in optimizers.items()},
                      ema_params=ema)


@torch.no_grad()
def update_ema(ema_params: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               updates: int, *, decay: float = 0.9999, tau: float = 2000.0) -> None:
    """In place: ``e = e * d + (1 - d) * p`` with the warm-up ramp
    ``d = decay * (1 - exp(-updates / tau))`` (fp32, as the JAX package)."""
    if not ema_params:
        return
    device = next(iter(ema_params.values())).device
    u = torch.tensor(float(updates), dtype=torch.float32, device=device)
    d = decay * (1.0 - torch.exp(-u / tau))
    for name, e in ema_params.items():
        e.copy_(e * d + (1.0 - d) * params[name].to(e.dtype))
