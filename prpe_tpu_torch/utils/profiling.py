"""Profiling and tracing helpers (``prpe_tpu/utils/profiling.py``).

Counterparts of the reference's observability hooks:
  * thop's FLOP and parameter ``profile()`` (reference:
    training/yolopt/main.py:242-256) -> ``count_params`` and
    ``count_flops`` (``torch.utils.flop_counter.FlopCounterMode``);
  * ``trace``: a ``torch.profiler`` capture written as a Chrome trace, with
    the program's own spans and counters beside it.

**Spans and counters of the cascade** (``infer/cascade.py``). Tracing is on
exactly while a ``torch.profiler`` records (:func:`tracing`, the flag torch
itself sets); nothing else switches it. With it off, :func:`call` returns a
shared no-op whose spans are one shared ``nullcontext``: no profiler range,
no CUDA event, nothing kept. With it on, every call of the runner keeps

* its spans: each opens a ``torch.profiler.record_function`` range of its
  name, so it lies in the same Chrome trace as the kernels, and keeps its
  name, call id, parent, host start and end in ns on that trace's clock
  (``time.time_ns()``, which is what the exported trace's
  ``baseTimeNanoseconds + ts * 1000`` reads) and its device ms: the time,
  on the stream current when the call started, between two CUDA events
  recorded at its boundaries, busy plus waiting for launches (on the CPU,
  its host duration);
* its counters: ints, masks the runner computed anyway (summed only when
  read, so a call gets no added kernel and no sync) and the kernel launches
  of the call read from ``ops/kernels/_build.py::launches``.

The spans of one call (name: parent, what it covers):

  * ``cascade.call``: none; all of ``run``;
  * ``cascade.upload``: call; frames and gallery to the device, uint8 to
    the compute dtype;
  * ``cascade.detect``: call; both detectors, decode, NMS (K1);
  * ``cascade.person_yolo``, ``cascade.face_yolo``: detect; a detector's
    forward;
  * ``cascade.face``: call; top-F, face crops, IR-Net, gallery match,
    scatter back;
  * ``cascade.irnet``: face; IR-Net's forward;
  * ``cascade.pose``: call; gate, top-G, pose crops, ViTPose, heatmap
    decode, keypoints;
  * ``cascade.vitpose``: pose; ViTPose's forward(s).

With RT-DETR as the person detector (``person_detector="rtdetr"``),
``cascade.person_rtdetr`` (detect; the whole detector and the person
column's top-K) takes ``cascade.person_yolo``'s place, and holds
``rtdetr.backbone`` (ResNet-50-vd), ``rtdetr.encoder`` (the input
projections, AIFI, CCFM), ``rtdetr.select`` (the decoder's input
projections, anchors, top-300) and ``rtdetr.decoder`` (the decoder layers
and heads).

The counters of one call are the gating funnel: ``frames`` -> ``persons``
(valid detections) and ``faces`` -> ``face_slots_used`` of ``face_slots``
(top-F) -> ``matched_faces`` -> ``gated_persons`` -> ``pose_slots_used`` of
``pose_slots`` (top-G), with ``face_budget_saturated`` (1 where valid faces
outnumbered the face slots) and the call's NMS (K1), packed attention (K2),
fused eval BatchNorm and deformable attention launches, ``k1_launches``,
``k2_launches``, ``bn_act_launches`` and ``msda_launches``, and
``bn_act_residual_launches``, the fused BatchNorms that also added a
residual (RT-DETR's bottlenecks and RepVGG blocks; each also counts in
``bn_act_launches``); 0 where the path has no such kernel.

The records of the most recent ``RING_CALLS`` calls are kept. :func:`spans`
and :func:`counters` return those of the latest stretch of calls during
which tracing was on (a call with tracing off, or :func:`trace`'s start,
ends a stretch), so a reader never mixes an earlier window's calls into
its own. :func:`trace` writes them as ``spans.json`` beside ``trace.json``:
the operator's way to read the funnel and each stage's host and device time.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Callable, Dict, Iterable, List

import torch
import torch.autograd.profiler as _autograd_profiler

from prpe_tpu_torch.ops.kernels._build import launches

# calls whose records are kept: at 9 spans a call, 18 CUDA events and about
# ten small masks each, a few MB of host memory at most
RING_CALLS = 1024
# kernel route in ``_build.launches`` -> the counter of its launches a call
LAUNCH_COUNTERS = {"nms": "k1_launches", "mhsa": "k2_launches", "bn_act": "bn_act_launches",
                   "bn_act_residual": "bn_act_residual_launches", "msda": "msda_launches"}


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


@contextlib.contextmanager
def trace(log_dir: str = "prpe_trace"):
    """``torch.profiler`` capture of the CPU and, where there is one, the
    card; writes ``trace.json`` (Chrome trace format) and the program's
    spans and counters of the captured calls, ``spans.json``
    (``{"ring_calls", "spans", "counters"}``), into ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _state["stretch"] = _state["next"]  # a new stretch starts here
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"ring_calls": RING_CALLS, "spans": spans(), "counters": counters()}, f)


# ---- the program's spans and counters --------------------------------------

def tracing() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler.profile``)
    records now: the module flag both set on start and clear on stop."""
    return _autograd_profiler._is_profiler_enabled


_NULL = contextlib.nullcontext()
_ring: collections.deque = collections.deque(maxlen=RING_CALLS)
# the next call's id, the last traced call's and the least of the latest stretch
_state = {"next": 0, "last": -2, "stretch": 0}


class _Off:
    """The call of a run with tracing off: every span is ``_NULL``."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def span(self, name: str):
        return _NULL

    def keep(self, **counters) -> None:
        pass


_OFF = _Off()


class _Span:
    """One span of a traced call; see the module's docstring."""

    def __init__(self, call: "_Call", name: str):
        self.call, self.name = call, name

    def __enter__(self):
        open_ = self.call.open
        self.parent = open_[-1] if open_ else None
        open_.append(self.name)
        self.call.spans.append(self)
        self.range = _autograd_profiler.record_function(self.name)
        self.start_ns = time.time_ns()  # read just before the range opens
        self.range.__enter__()
        self.events = None
        if self.call.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.call.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.call.stream)
        self.range.__exit__(None, None, None)
        self.end_ns = time.time_ns()
        self.call.open.pop()
        return False

    def record(self) -> dict:
        if self.events is None:
            device_ms = (self.end_ns - self.start_ns) / 1e6
        else:
            self.events[1].synchronize()
            device_ms = self.events[0].elapsed_time(self.events[1])
        return {"name": self.name, "call": self.call.id, "parent": self.parent,
                "host_start_ns": self.start_ns, "host_end_ns": self.end_ns,
                "device_ms": device_ms}


class _Call(_Span):
    """A traced call: its outermost span, its inner spans and counters."""

    def __init__(self, name: str, call_id: int, frames: int, device: torch.device):
        self.id = call_id
        # the stream current at the call's start times all its spans (fetched
        # once: ``current_stream`` costs more host time than an event record)
        self.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self.open: List[str] = []
        self.spans: List[_Span] = []
        self.kept = {"frames": frames}
        self.launches_before = dict(launches)
        super().__init__(self, name)

    def __exit__(self, *exc):
        super().__exit__(*exc)
        for route, counter in LAUNCH_COUNTERS.items():
            self.kept[counter] = launches[route] - self.launches_before[route]
        if exc[0] is None:
            _ring.append(self)
        return False

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def keep(self, **counters) -> None:
        """Keep ints or tensors (masks, summed when read) as counters."""
        self.kept.update(counters)

    def counters(self) -> dict:
        out = {"call": self.id}
        for name, value in self.kept.items():
            out[name] = int(value.sum()) if isinstance(value, torch.Tensor) else int(value)
        return out


def call(name: str, frames: int, device: torch.device):
    """The context of one call of a runner: ``_OFF`` with tracing off, else
    a fresh traced call (its outermost span ``name``) whose ``span(name)``
    opens an inner span and ``keep(**counters)`` keeps counters."""
    call_id = _state["next"]
    _state["next"] = call_id + 1
    if not tracing():
        return _OFF
    if call_id != _state["last"] + 1:
        _state["stretch"] = call_id
    _state["last"] = call_id
    return _Call(name, call_id, frames, device)


def _latest_stretch() -> List[_Call]:
    return [c for c in _ring if c.id >= _state["stretch"]]


def spans() -> List[dict]:
    """Span records of the latest stretch of traced calls, in the order
    the spans opened."""
    return [s.record() for c in _latest_stretch() for s in c.spans]


def counters() -> List[dict]:
    """One counter dict (with its ``call`` id) a call of the latest stretch."""
    return [c.counters() for c in _latest_stretch()]
