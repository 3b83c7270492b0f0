"""One run of one cell: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.

Everything is found by name, so that a later change adds a cell, a
configuration or a per-layer metric by adding files:

- ``BENCHMARK.json`` (the checkout's root) lists the cells and metrics;
- ``benchmark/traffic/<cell>.json``: the cell's traffic and its ``config``;
- ``benchmark/configs/<config>.json``: the sizes, the dtype and the
  ``driver``;
- ``benchmark/drivers/<driver>.py``: a ``Driver`` class with ``setup``,
  ``call``, ``window``, ``modules``, ``units``, ``release`` and ``check``
  (and ``reference_s``, where its set-up runs the reference), and the
  ``FAULTS`` that ``control.py`` puts in the program's place;
- ``benchmark/metrics/<metric>.py``: ``read(summary, ctx)`` -> a number or
  None, for each per-layer metric.

A run sets up (process start to the window's first call is ``setup_s``,
less the seconds a driver spends on the reference's own work there, its
``reference_s``),
measures for ``--seconds`` (``--trace 0``) or profiles the cell's
``trace_calls`` calls (``--trace 1``), reads the peak of device memory, frees
the program, judges the window's answers against the plain reference, and
prints one JSON line. Without the cards the cell asks for it exits 2 and
prints no result; if JAX or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from benchmark import trace as tr

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "prpe_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: Path, name: str):
    """(manifest, cell entry, traffic, config) of cell ``name`` under ``root``."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    traffic = json.loads((root / "benchmark" / "traffic" / f"{name}.json").read_text())
    cfg = json.loads((root / "benchmark" / "configs" / f"{traffic['config']}.json").read_text())
    return manifest, cells[name], traffic, cfg


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or its per-layer ones with ``trace``."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in moved]


def run(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
        device: Optional[torch.device] = None, dtype: Optional[torch.dtype] = None,
        kind: str = "program", calls: Optional[int] = None) -> Dict:
    """One run -> the result object. ``kind`` puts the control or a fault
    of the driver's ``FAULTS`` in the program's place, and ``calls`` makes
    that many untimed calls in place of the window: both for the readings
    of ``control.py``. ``device`` and ``dtype`` are for the CPU tests alone;
    a run from the command line takes the card and the configuration's
    dtype. The program's numeric settings (TF32 among them) are its own:
    the reference sets its own inside the driver."""
    manifest, cell, traffic, cfg = load_cell(root, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"{workload} needs {cell['chips']} CUDA device(s); found {found}")
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        for var, sub in CACHES.items():
            os.environ[var] = str(root / "build" / "bench_cache" / sub)
    dtype = dtype or getattr(torch, cfg["dtype"])
    cuda = device.type == "cuda"
    driver_mod = load_module(root / "benchmark" / "drivers" / f"{cfg['driver']}.py",
                             f"bench_driver_{cfg['driver']}")
    cls = driver_mod.Driver if kind == "program" else driver_mod.FAULTS[kind]
    driver = cls(cfg, traffic, seed, device, dtype, log)
    driver.setup()
    reference_s = getattr(driver, "reference_s", 0.0)
    setup_s = process_age() - reference_s
    log(f"set-up {setup_s} s ({reference_s} s of the reference's work left out)")

    metrics: Dict[str, float] = {}
    extra_device: Dict[str, float] = {}
    breakdown = None
    if calls is not None:
        for i in range(calls):
            driver.call(i)
    elif not trace:
        metrics.update(driver.window(seconds))
        metrics["setup_s"] = setup_s
    else:
        summary = profile(driver, traffic["trace_calls"], cuda)
        extra_device = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
        breakdown = tr.breakdown(summary)
        ctx = {"cfg": cfg, "traffic": traffic, "units": driver.units()}
        for m in cell_metrics(manifest, workload, True):
            reader = load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(summary, ctx)
            if value is not None:
                metrics[m["name"]] = value
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if not trace:
        metrics["peak_device_gib"] = peak / 2**30

    driver.release()
    numbers = driver.check()
    limits = traffic["limits"]
    correct = all(numbers[k] is not None and numbers[k] <= limits[k] for k in numbers)
    attempted = len(driver.calls)

    units = {m["name"]: m["unit"] for m in cell_metrics(manifest, workload, trace)}
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": 0,
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items() if k in units},
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak, **extra_device},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    return result


def profile(driver, calls: int, cuda: bool) -> Dict:
    """``calls`` calls under ``torch.profiler`` with the driver's modules
    annotated -> the trace's reduction plus ``calls``. The trace is written
    under ``TMPDIR``, read and deleted."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tr.annotate(driver.modules()), torch_profile(activities=acts) as prof:
        with record_function(tr.WINDOW):
            for i in range(calls):
                driver.call(i)
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="bench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        log(f"trace {os.path.getsize(path)} bytes")
        summary = tr.read_trace(path)
    finally:
        os.unlink(path)
    summary["calls"] = calls
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found}; the benchmark measures prpe_tpu_torch alone")
        return 3
    log(f"run {time.perf_counter() - t0} s")
    for name, row in result["check"].items():
        log(f"check {name} {row['value']} limit {row['limit']}")
    print(json.dumps(result), flush=True)
    return 0
