"""Kernel-level profiles from ``torch.profiler``, and a dump of every kernel
of the newest trace: the port's ``tools/dump_trace_ops.py``.

    python -m prpe_tpu_torch.tools.dump_trace_ops [TRACE.json] [--iters N] [--top N]

Without a path it reads the newest Chrome trace under ``build/traces``
(written by ``profile_cascade`` and ``profile_train``) and prints every
kernel (or the ``--top`` N) with its device ms per iteration, its count and
its name, most time first, then one JSON line with the totals. On a CPU trace the
"kernels" are the CPU operators, timed by their self time.

:func:`profile_top` is the aggregation the tools share (and
``chip_smoke.py`` imports): device time per kernel name from the
profiler's kernel events (not the operators that launch them, which would
count the time twice), the attention kernels and K4's stages picked out,
and, from the exported trace, the card's busy share over the profiled
window and the device time per annotated module.

Departure from the JAX tool: the JAX trace's HLO ops carry a category and
a source line; a PyTorch trace's kernels carry neither, so the module is
found from the ``module::<name>`` ranges that :func:`annotate_modules`
records around each forward.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
TRACE_DIR = ROOT / "build" / "traces"
WINDOW = "prpe::window"
OUTSIDE = "(outside any module)"


@contextlib.contextmanager
def annotate_modules(modules):
    """A ``module::<name>`` profiler range around every forward of each
    ``name -> nn.Module`` of ``modules`` while the block runs."""
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


def _self_times(events):
    """CPU operator events -> (name, self us, tid, ts) with each event's
    direct children's time taken off (per thread, nesting by time)."""
    out = []
    by_tid = collections.defaultdict(list)
    for e in events:
        by_tid[e["tid"]].append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            while stack and stack[-1][0]["ts"] + stack[-1][0]["dur"] <= e["ts"]:
                out.append(stack.pop())
            if stack:
                stack[-1][1] -= e["dur"]
            stack.append([e, e["dur"]])
        out += stack
    return [(e["name"], max(s, 0.0), e["tid"], e["ts"]) for e, s in out]


def trace_summary(path, iters: int = 1) -> dict:
    """From an exported Chrome trace: ``ops`` (name -> [us per iteration,
    count]), ``busy_share`` (device time over the ``prpe::window`` range),
    ``by_module`` (device ms per iteration per ``module::`` range enclosing
    the launch; launches outside one under ``(outside any module)``),
    ``launches`` per iteration and ``device``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    # the card's work: kernels, copies and fills
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    device = "cuda" if kernels else "cpu"
    window = [e for e in events if e.get("name") == WINDOW]
    t0, t1 = ((window[0]["ts"], window[0]["ts"] + window[0]["dur"]) if window
              else (min(e["ts"] for e in events), max(e["ts"] + e["dur"] for e in events)))
    annotations = [e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("module::")]

    def module_at(tid, ts):
        inner = None
        for a in annotations:
            if a["tid"] == tid and a["ts"] <= ts <= a["ts"] + a["dur"]:
                if inner is None or a["dur"] < inner["dur"]:
                    inner = a
        return OUTSIDE if inner is None else inner["name"][len("module::"):]

    if device == "cuda":
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        ops = []
        for k in kernels:
            site = launch.get(k.get("args", {}).get("correlation"))
            mod = OUTSIDE if site is None else module_at(site["tid"], site["ts"])
            ops.append((k["name"], k["dur"], mod))
    else:
        cpu = [e for e in events if e.get("cat") == "cpu_op"]
        ops = [(n, us, module_at(tid, ts)) for n, us, tid, ts in _self_times(cpu)]
    table = collections.defaultdict(lambda: [0.0, 0])
    by_module = collections.Counter()
    busy = 0.0
    for name, us, mod in ops:
        table[name][0] += us / iters
        table[name][1] += 1
        by_module[mod] += us / 1e3 / iters
        busy += us
    return {"device": device, "ops": dict(table), "launches": len(ops) / iters,
            "busy_share": busy / max(t1 - t0, 1e-9), "window_ms": (t1 - t0) / 1e3 / iters,
            "by_module": dict(by_module.most_common())}


def profile_top(fn, top: int = 12, iters: int = 1, modules=None, name: str = None):
    """Profile ``iters`` calls of ``fn``: device time per kernel from the
    profiler's kernel events (``kernel_ms``, ``launches``, the ``top``
    rows (ms, count, name)), the attention kernels of the port (K2 and K3,
    K4's stage) and K4's LayerNorm and GEMM times. With ``name`` the trace
    is exported to ``build/traces/<name>-<ns>.json`` and the summary adds
    ``trace``, ``busy_share``, ``window_ms`` and ``by_module`` (``modules``:
    name -> nn.Module to annotate). On the CPU the rows are the
    operators' self times."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with annotate_modules(modules or {}), profile(activities=activities) as prof:
        with record_function(WINDOW):
            for _ in range(iters):
                fn()
            if cuda:
                torch.cuda.synchronize()
    from prpe_tpu_torch.utils import profiling

    # ranges, not work, on the card's timeline too: the window, the modules'
    # ranges and the spans the cascade runner opens while a profiler records
    ranges = {WINDOW} | {s["name"] for s in profiling.spans()}
    rows = []
    for e in prof.key_averages():
        if e.key in ranges or e.key.startswith("module::"):
            continue
        if cuda and e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3 / iters, e.count / iters, e.key[:80]))
        elif not cuda and e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0:
            rows.append((e.self_cpu_time_total / 1e3 / iters, e.count / iters, e.key[:80]))
    rows.sort(reverse=True)
    attention = [r for r in rows if "mhsa_" in r[2] and "_kernel" in r[2]]
    ln_mhsa = {stage: sum(r[0] for r in rows if any(f"::{p}" in r[2] for p in patterns))
               for stage, patterns in (("layernorm", ("layernorm_kernel",)),
                                       ("gemm", ("gemm_f32_kernel", "gemm_bf16_kernel")))}
    ln_mhsa["attention"] = sum(r[0] for r in attention)
    out = {"kernel_ms": sum(r[0] for r in rows), "launches": sum(r[1] for r in rows),
           "attention_ms": sum(r[0] for r in attention),
           "attention_launches": sum(r[1] for r in attention), "ln_mhsa": ln_mhsa,
           "top": [list(r) for r in rows[:top]]}
    if name is not None:
        TRACE_DIR.mkdir(parents=True, exist_ok=True)
        path = TRACE_DIR / f"{name}-{time.time_ns()}.json"
        prof.export_chrome_trace(str(path))
        summary = trace_summary(path, iters)
        out.update(trace=str(path), busy_share=summary["busy_share"],
                   window_ms=summary["window_ms"], by_module=summary["by_module"])
    return out


def print_profile(title: str, p: dict, top: int = 12) -> None:
    """The human-readable tables of a :func:`profile_top` result."""
    print(f"-- {title}: {p['kernel_ms']:.3f} ms of kernels in {p['launches']:.0f} launches"
          + (f", busy share {p['busy_share']:.3f} of {p['window_ms']:.3f} ms"
             if "busy_share" in p else "") + " --")
    for ms, count, name in p["top"][:top]:
        print(f"{ms:9.3f} ms x{count:6.1f} {name}")
    if p.get("by_module"):
        print("-- by module --")
        for mod, ms in p["by_module"].items():
            print(f"{ms:9.3f} ms  {mod}")


def newest_trace() -> pathlib.Path:
    traces = sorted(TRACE_DIR.glob("*.json"), key=lambda p: p.stat().st_mtime)
    if not traces:
        raise SystemExit(f"dump_trace_ops: no trace under {TRACE_DIR}: run profile_cascade "
                         "or profile_train first")
    return traces[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", nargs="?", help="a Chrome trace (default: the newest)")
    ap.add_argument("--iters", type=int, default=1, help="iterations the trace holds")
    ap.add_argument("--top", type=int, default=None, help="only the N longest")
    args = ap.parse_args(argv)
    path = pathlib.Path(args.trace) if args.trace else newest_trace()
    s = trace_summary(path, args.iters)
    rows = sorted(s["ops"].items(), key=lambda kv: -kv[1][0])
    total = sum(us for us, _ in s["ops"].values())
    print(f"{path}: {s['device']} trace, total {total / 1e3:.3f} ms an iteration, "
          f"{len(rows)} distinct kernels")
    for name, (us, count) in rows[:args.top or len(rows)]:
        print(f"{us / 1e3:9.4f} ms x{count:5d} {name[:140]}")
    print(json.dumps({"tool": "dump_trace_ops", "trace": str(path), "device": s["device"],
                      "total_ms": total / 1e3, "distinct_kernels": len(rows),
                      "launches": s["launches"], "busy_share": s["busy_share"],
                      "by_module": s["by_module"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
