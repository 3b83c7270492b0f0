"""Where the greedy-NMS kernel's time goes, from ``clock64()`` and
``%globaltimer`` probes.

    python3 -m prpe_tpu_torch.tools.nms_phases [--source FILE]
        [--variant NAME 'OLD=>NEW' ...] ... [--batch 32] [--k 256 1024]

Copies an NMS kernel source (default: ``prpe_tpu_torch/csrc/nms.cu``; any
earlier version of it with the same C entry point works), applies each
variant's text edits (as ``variants.py`` does; variant ``as_is`` has none),
inserts probes, builds with the flags of ``_build.py`` into
``build/prpe_tpu_torch/probe/`` and runs on the card. Thread 0 of each block
reads ``clock64()`` at marks placed by the source's own text: after the
kernel's ``extern __shared__`` declaration (``start``); before each line
holding ``// phase N:``, ``cluster.sync()`` or ``cluster_wait();``; before the last
``for (int j = tid; j < k; j += kThreads)`` (the keep mask's store,
``store``); and at the kernel's last line (``end``). It also reads the
global nanosecond timer at ``start`` and ``end``.

For each variant, K and input kind (every candidate valid, as in the cascade
with ``conf_threshold=0``; or clustered boxes with 70 % valid), it prints
one JSON line: the median over blocks and launches of the cycles between
consecutive marks (only blocks that pass both marks count: in a clustered
kernel, later marks are the scanning block's), the same in µs at the card's
clock-rate attribute, the spread of the blocks' start times and the span
from the first start to the last end (global timer), and the probed
kernel's median CUDA-event time. The probes add a few instructions; the
kernel rows of ``chip_smoke.py`` time the unprobed kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from prpe_tpu_torch.ops.kernels import _build
from prpe_tpu_torch.ops.kernels.nms import LIBRARY

MAX_MARKS = 12
MAX_BLOCKS = 8192
_PRELUDE = f"""
__device__ long long prpe_phase_clock[{MAX_BLOCKS * MAX_MARKS}];
__device__ unsigned long long prpe_phase_time[{MAX_BLOCKS * 2}];
__device__ __forceinline__ unsigned long long prpe_globaltimer() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}}
#define PRPE_MARK(n) do {{ if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) \\
    prpe_phase_clock[blockIdx.x * {MAX_MARKS} + (n)] = clock64(); }} while (0)
#define PRPE_TIME(n) do {{ if (threadIdx.x == 0 && blockIdx.x < {MAX_BLOCKS}) \\
    prpe_phase_time[blockIdx.x * 2 + (n)] = prpe_globaltimer(); }} while (0)
"""
_EPILOGUE = f"""
extern "C" int prpe_phase_reset(void* stream) {{
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, prpe_phase_clock);
  if (e == cudaSuccess) e = cudaMemsetAsync(p, 0, sizeof(long long) * {MAX_BLOCKS * MAX_MARKS},
                                            (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, prpe_phase_time);
  if (e == cudaSuccess) e = cudaMemsetAsync(p, 0, sizeof(long long) * {MAX_BLOCKS * 2},
                                            (cudaStream_t)stream);
  return (int)e;
}}
extern "C" int prpe_phase_read(void* clocks, void* times) {{
  cudaError_t e = cudaMemcpyFromSymbol(clocks, prpe_phase_clock,
                                       sizeof(long long) * {MAX_BLOCKS * MAX_MARKS});
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(times, prpe_phase_time, sizeof(long long) * {MAX_BLOCKS * 2});
  return (int)e;
}}
extern "C" int prpe_clock_khz() {{
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  return khz;
}}
"""
_STORE_LOOP = re.compile(r"for \(int j = tid; j < k; j \+= kThreads\)")
_PHASE = re.compile(r"// (phase \d+):")


def instrument(src: str):
    """The source with probes, and the names of its marks in order."""
    lines = src.splitlines()
    first_include = max(i for i, line in enumerate(lines) if line.startswith("#include"))
    start = next(i for i, line in enumerate(lines) if "extern __shared__" in line)
    store = max(i for i, line in enumerate(lines) if _STORE_LOOP.search(line))
    end = next(i for i in range(store, len(lines)) if lines[i] == "}")  # the kernel's last line
    before = {store: "store", end: "end"}
    n_sync = 0
    for i in range(start + 1, store):
        m = _PHASE.search(lines[i])
        if m:
            before[i] = m.group(1)
        elif "cluster.sync()" in lines[i] or "cluster_wait();" in lines[i]:
            n_sync += 1
            before[i] = f"cluster_wait_{n_sync}"
    names = ["start"] + [before[i] for i in sorted(before)]
    if len(names) > MAX_MARKS:
        raise ValueError(f"{len(names)} marks, at most {MAX_MARKS}")
    out, n = [], 1
    for i, line in enumerate(lines):
        if i in before:
            out.append(f"  PRPE_MARK({n});" + ("  PRPE_TIME(1);" if i == end else ""))
            n += 1
        out.append(line)
        if i == start:
            out.append("  PRPE_MARK(0);  PRPE_TIME(0);")
        if i == first_include:
            out.append(_PRELUDE)
    return "\n".join(out) + "\n" + _EPILOGUE, names


def build(name: str, src: str) -> ctypes.CDLL:
    probe = _build.BUILD_DIR / "probe"
    probe.mkdir(parents=True, exist_ok=True)
    cu, lib_path = probe / f"nms_{name}.cu", probe / f"libnms_{name}.so"
    cu.write_text(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *LIBRARY.flags, "-o", str(lib_path), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.prpe_nms_keep.argtypes = LIBRARY.entry_points["prpe_nms_keep"]
    lib.prpe_phase_reset.argtypes = [_build.PTR]
    lib.prpe_phase_read.argtypes = [_build.PTR, _build.PTR]
    for fn in (lib.prpe_nms_keep, lib.prpe_phase_reset, lib.prpe_phase_read, lib.prpe_clock_khz):
        fn.restype = _build.INT
    return lib


def inputs(b: int, k: int, all_valid: bool, gen: torch.Generator):
    """Boxes clustered around a few centres per image; every candidate valid,
    or 70 % valid and not a prefix."""
    dev = torch.device("cuda")
    u = lambda *s: torch.rand(*s, generator=gen, device=dev)  # noqa: E731
    centres = 50 + 500 * u(b, max(8, k // 32), 2)
    pick = (u(b, k) * centres.shape[1]).long()
    cxy = torch.gather(centres, 1, pick[..., None].expand(b, k, 2)) + 16 * (u(b, k, 2) - 0.5)
    wh = 20 + 60 * u(b, k, 2)
    boxes = torch.cat([cxy - wh / 2, cxy + wh / 2], -1).contiguous()
    valid = torch.ones(b, k, dtype=torch.bool, device=dev) if all_valid else u(b, k) < 0.7
    return boxes, valid


def measure(lib, names, b: int, k: int, all_valid: bool, thr: float, runs: int, gen) -> dict:
    boxes, valid = inputs(b, k, all_valid, gen)
    keep = torch.empty(b, k, dtype=torch.bool, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    clocks = torch.zeros(MAX_BLOCKS, MAX_MARKS, dtype=torch.int64)
    times = torch.zeros(MAX_BLOCKS, 2, dtype=torch.int64)

    def launch():
        err = lib.prpe_nms_keep(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, thr,
                                stream)
        _build.check(err, "probed nms_keep")

    gaps = {f"{names[n]}->{names[n + 1]}": [] for n in range(len(names) - 1)}
    spread, span = [], []
    for _ in range(runs):
        _build.check(lib.prpe_phase_reset(stream), "probe reset")
        launch()
        torch.cuda.synchronize()
        _build.check(lib.prpe_phase_read(clocks.data_ptr(), times.data_ptr()), "probe read")
        for n, key in enumerate(gaps):
            both = (clocks[:, n] != 0) & (clocks[:, n + 1] != 0)
            gaps[key] += (clocks[both, n + 1] - clocks[both, n]).tolist()
        started = times[times[:, 0] != 0, 0]
        ended = times[times[:, 1] != 0, 1]
        spread.append(int(started.max() - started.min()) / 1e3)
        span.append(int(ended.max() - started.min()) / 1e3)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for i in range(runs):
        launch()
        events[i + 1].record()
    torch.cuda.synchronize()
    ms = statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))
    khz = lib.prpe_clock_khz()
    cycles = {key: statistics.median(v) for key, v in gaps.items() if v}
    return dict(B=b, K=k, all_valid=all_valid, thr=thr, cycles=cycles,
                us_at_clock_rate={key: c / khz * 1e3 for key, c in cycles.items()},
                clock_rate_mhz=khz / 1e3, start_spread_us=statistics.median(spread),
                first_start_to_last_end_us=statistics.median(span), probed_kernel_ms=ms)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=_build.CSRC / "nms.cu")
    parser.add_argument("--variant", nargs="+", action="append", default=[],
                        metavar=("NAME", "EDIT"), help="a name, then OLD=>NEW edits")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--k", type=int, nargs="+", default=[256, 1024])
    parser.add_argument("--thr", type=float, default=0.65)
    parser.add_argument("--runs", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("nms_phases: needs a CUDA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    base = args.source.read_text()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, *edits in [["as_is"], *args.variant]:
        src = base
        for edit in edits:
            old, new = edit.split("=>", 1)
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} is not in {args.source}")
            src = src.replace(old, new)
        probed, names = instrument(src)
        lib = build(name, probed)
        for k in args.k:
            for all_valid in (True, False):
                row = measure(lib, names, args.batch, k, all_valid, args.thr, args.runs, gen)
                print(json.dumps({"source": str(args.source), "variant": name, **row,
                                  "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
