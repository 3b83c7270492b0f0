"""Profiling and tracing helpers (``prpe_tpu/utils/profiling.py``).

Counterparts of the reference's observability hooks:
  * thop's FLOP and parameter ``profile()`` (reference:
    training/yolopt/main.py:242-256) -> ``count_params`` and
    ``count_flops`` (``torch.utils.flop_counter.FlopCounterMode``);
  * per-step GPU-memory logging (reference: training/yolopt/main.py:130)
    -> ``device_memory_stats`` (``torch.cuda.memory_stats``);
  * ``trace``: a ``torch.profiler`` capture written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch


def count_flops(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, without gradients.

    ``FlopCounterMode`` counts the matrix products and convolutions (two
    FLOPs a multiply-add) and nothing else; the JAX package's XLA cost
    analysis also counts elementwise operations, so the two differ by the
    share of those (for YOLOv11-n: about 0.15 % at 640^2, 14 % at 64^2,
    where the head's elementwise work weighs more). ``bytes_accessed`` is
    -1.0, the JAX function's value when its analysis has no count.
    """
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": -1.0}


def count_params(params: Iterable[torch.Tensor]) -> int:
    """Elements over ``params`` (``model.parameters()`` or the values of a
    name -> tensor dict)."""
    if isinstance(params, dict):
        params = params.values()
    return sum(p.numel() for p in params)


def device_memory_stats(device=None) -> Dict[str, int]:
    """``torch.cuda.memory_stats`` of ``device`` (the current card); empty
    without CUDA."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


@contextlib.contextmanager
def trace(log_dir: str = "prpe_trace"):
    """``torch.profiler`` capture of the CPU and, where there is one, the
    card; writes ``trace.json`` (Chrome trace format) into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Simple images/sec meter with warmup exclusion."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._n_calls = 0
        self._items = 0
        self._t0: Optional[float] = None

    def step(self, n_items: int):
        self._n_calls += 1
        if self._n_calls == self.warmup:
            self._t0 = time.perf_counter()
            self._items = 0
        elif self._n_calls > self.warmup:
            self._items += n_items

    @property
    def items_per_sec(self) -> float:
        if self._t0 is None or self._items == 0:
            return 0.0
        return self._items / (time.perf_counter() - self._t0)
