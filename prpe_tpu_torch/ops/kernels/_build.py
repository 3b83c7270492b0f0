"""Build the CUDA sources in ``prpe_tpu_torch/csrc/`` at first use, load
them with ctypes and launch their entry points.

Each ``csrc/<name>.cu`` exports plain C entry points and is compiled alone
by ``nvcc`` into ``build/prpe_tpu_torch/lib<name>-<hash>.so`` at the root of
the checkout. The hash covers the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header is rebuilt. Only sources in the
repository are compiled.

This module names no kernel. Each wrapper declares its source as a
:class:`Library` and launches through :meth:`Library.launch`, which adds one
to the launch's counters in ``launches``, so a caller can show that a run
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "prpe_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the ctypes kinds of the entry points' parameters
PTR, INT, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# every declared library by source name, in the order of declaration
libraries: Dict[str, "Library"] = {}
# launches per route: one zero a route from its library's declaration on
launches: Dict[str, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


class Library:
    """``csrc/<name>.cu`` as its wrapper declares it: ``entry_points`` maps
    each ``extern "C"`` symbol to its ctypes argument types (each returns a
    CUDA error code and takes the stream last), ``routes`` are the counters
    in ``launches`` its launches add to, ``flags`` its nvcc flags beyond
    ``NVCC_FLAGS``. Constructing one registers it."""

    def __init__(self, name: str, entry_points: Dict[str, Sequence], routes: Sequence[str],
                 flags: Sequence[str] = ()):
        self.name, self.entry_points = name, entry_points
        self.routes, self.flags = tuple(routes), list(flags)
        self._dll: Optional[ctypes.CDLL] = None
        self._fns: Dict[str, Callable[..., int]] = {}
        libraries[name] = self
        for route in self.routes:
            launches.setdefault(route, 0)

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._dll is None:
            _finish(self.name, _start(self.name, self.flags))
            dll = ctypes.CDLL(str(_target(self.name, self.flags)))
            for sym, argtypes in self.entry_points.items():
                fn = getattr(dll, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._dll = dll
        return self._dll

    def launch(self, symbol: str, routes: Sequence[str], x: torch.Tensor, *args) -> None:
        """``symbol(*args, stream)`` on CUDA tensor ``x``'s device and its
        current stream; raises on a CUDA error and adds one to each of
        ``routes``. The host's cost counts here (hundreds of launches a
        cascade call): the symbol is looked up once, the device and stream
        come from the raw getters, and the device is switched only where
        ``x`` is not on the current one."""
        index = x.get_device()
        if index != torch._C._cuda_getDevice():
            with torch.cuda.device(index):
                return self.launch(symbol, routes, x, *args)
        fn = self._fns.get(symbol)
        if fn is None:
            fn = self._fns[symbol] = getattr(self.load(), symbol)
        check(fn(*args, torch._C._cuda_getCurrentRawStream(index)), f"{symbol} launch")
        for route in routes:
            launches[route] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str, flags: Sequence[str] = ()) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(flags)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, flags: Sequence[str]) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name, flags)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.prpe_paths = (tmp, out)  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp, out = proc.prpe_paths  # type: ignore[attr-defined]
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Build every declared library, one nvcc per source, all started
    together.

    Returns the compiler's output per source (registers, shared memory and
    spills from ``-Xptxas -v``); empty for a library that was already built.
    """
    procs = {name: _start(name, lib.flags) for name, lib in libraries.items()}
    return {name: _finish(name, proc) for name, proc in procs.items()}


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
