"""What the measuring tools share: the card's name and power limit,
progress lines on stderr, result lines on stdout, and device time from
CUDA events.

A tool prints its numbers on stdout, one JSON object a line, and its
diagnostics on stderr, as the repository's JAX scripts do.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

_T0 = time.perf_counter()


def log(tool: str, msg: str) -> None:
    """One progress line on stderr, with the seconds since the import."""
    print(f"[{tool} +{time.perf_counter() - _T0:.0f}s] {msg}", file=sys.stderr, flush=True)


def emit(record: dict) -> None:
    """One result line on stdout."""
    print(json.dumps(record), flush=True)


def card(device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card on a CUDA ``device``; "cpu" otherwise."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, runs: int = 10, warmup: int = 2) -> float:
    """Median time of one call of ``fn``: on a CUDA ``device`` from CUDA
    events around each of ``runs`` calls queued back to back behind a sleep
    kernel (the host's launch latency counts only where the calls cannot be
    queued as fast as the card runs them); on the CPU from the host clock."""
    for _ in range(warmup):
        fn()
    sync(device)
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize(device)
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


class Window:
    """Time of the work queued between ``start()`` and ``stop()``: CUDA
    events on a CUDA device (queued behind a sleep kernel, so the window
    starts when the card reaches it), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.device = device

    def start(self) -> None:
        sync(self.device)
        if self.cuda:
            torch.cuda._sleep(50_000_000)
            self.begin = torch.cuda.Event(enable_timing=True)
            self.begin.record()
        else:
            self.t = time.perf_counter()

    def stop(self) -> float:
        """Milliseconds since ``start()``, the queued work done."""
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize(self.device)
            return self.begin.elapsed_time(end)
        return (time.perf_counter() - self.t) * 1e3
