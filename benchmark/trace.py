"""Reduction of a ``torch.profiler`` Chrome trace to what the per-layer
readers read.

Device work is every kernel, copy and fill on the card's timeline. Its busy
time is the **union** of those intervals inside the traced window, so work
on two streams at once counts once. A kernel belongs to the module whose
``module::<name>`` range (put around each forward by the benchmark's own
hooks, :func:`annotate`) holds the host call that launched it, found through
the profiler's correlation ids. Each idle gap of the device is charged to the
innermost host operation that was running on the launching thread when the
gap began.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
from typing import Dict, List, Tuple

WINDOW = "bench::window"
OUTSIDE = "(outside)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def annotate(modules):
    """A ``module::<name>`` profiler range around every forward of each
    ``name -> nn.Module`` while the block runs."""
    from torch.autograd.profiler import record_function

    handles, stacks = [], collections.defaultdict(list)
    for name, module in modules.items():
        def pre(mod, inputs, name=name):
            rf = record_function(f"module::{name}")
            rf.__enter__()
            stacks[name].append(rf)

        def post(mod, inputs, output, name=name):
            stacks[name].pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(events, times):
    """For each of the sorted ``times``, the name of the innermost host event
    (of properly nested ``events``) covering it, or None."""
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i]["ts"] <= t:
            e = events[i]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"]:
                stack.pop()
            stack.append(e)
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
            stack.pop()
        out.append(stack[-1]["name"] if stack else None)
    return out


def summarize(events: List[dict]) -> Dict:
    """Chrome-trace ``X`` events -> the traced window's reduction (seconds)."""
    events = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if window:
        t0, t1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    else:
        t0 = min(e["ts"] for e in events)
        t1 = max(e["ts"] + e["dur"] for e in events)
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] + e["dur"] > t0 and e["ts"] < t1]
    busy = union([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device])
    busy_us = sum(e - s for s, e in busy)

    marks = sorted((a["ts"], a["ts"] + a["dur"], a["tid"], a["name"][len("module::"):])
                   for a in events if a.get("cat") == "user_annotation"
                   and a["name"].startswith("module::"))
    starts = [m[0] for m in marks]

    def module_at(tid, ts):
        best = None
        for s, e, mtid, name in marks[:bisect.bisect_right(starts, ts)]:
            if mtid == tid and s <= ts <= e and (best is None or s > best[0]):
                best = (s, name)
        return OUTSIDE if best is None else best[1]

    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    module_s: Dict[str, float] = collections.Counter()
    ops: Dict[str, List[float]] = {}
    host_tid = collections.Counter()
    for k in device:
        site = launch.get(k.get("args", {}).get("correlation"))
        mod = OUTSIDE if site is None else module_at(site["tid"], site["ts"])
        if site is not None:
            host_tid[site["tid"]] += 1
        module_s[mod] += k["dur"] / 1e6
        row = ops.setdefault(k["name"], [0.0, 0])
        row[0] += k["dur"] / 1e6
        row[1] += 1

    gaps = [(s, e) for (_, s), (e, _) in zip(busy, busy[1:])]
    if busy:
        gaps = [(t0, busy[0][0])] + gaps + [(busy[-1][1], t1)]
    else:
        gaps = [(t0, t1)]
    tid = host_tid.most_common(1)[0][0] if host_tid else None
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid
            and e.get("name") != WINDOW]
    names = _innermost(host, [s for s, _ in gaps])
    idle: Dict[str, float] = collections.Counter()
    for (s, e), name in zip(gaps, names):
        if e > s:
            idle[name or "(host outside any operator)"] += (e - s) / 1e6
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy_us / 1e6,
        "launches": sum(1 for k in device if k.get("cat") == "kernel"),
        "module_s": dict(module_s),
        "ops": ops,
        "idle_s": dict(idle),
    }


def read_trace(path) -> Dict:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The contract's ``breakdown``: the device operations that took the most
    time, and the idle time by what the host was doing."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    idle = sorted(summary["idle_s"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name, s] for name, (s, _) in ops],
            "idle_gaps": [[name, s] for name, s in idle]}
