"""Build the CUDA sources in ``prpe_tpu_torch/csrc/`` at first use and load
them with ctypes.

Each ``csrc/<name>.cu`` exports plain C entry points and is compiled alone
by ``nvcc`` into ``build/prpe_tpu_torch/lib<name>-<hash>.so`` at the root of
the checkout. The hash covers the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header is rebuilt. Only sources in the
repository are compiled.

Each wrapper adds one to its counter in ``launches`` where it launches its
kernel, so a caller can show that a run went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "prpe_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# NMS must reproduce the plain version's fp32 IoU bit for bit: no FMA
# contraction (IEEE division is nvcc's default without --use_fast_math).
EXTRA_FLAGS: Dict[str, List[str]] = {"nms": ["-fmad=false"]}

# C signatures of the entry points: name -> (symbol, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "nms": {"prpe_nms_keep": [_P, _P, _P, _I, _I, _F, _P]},
    "mhsa": {
        "prpe_mhsa_packed_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        "prpe_mhsa_packed_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        "prpe_mhsa_bhtd_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
        "prpe_mhsa_bhtd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    },
    "ln_mhsa": {
        "prpe_ln_mhsa_f32": [_P] * 13 + [_I] * 4 + [_F, _F, _P],
        "prpe_ln_mhsa_bf16": [_P] * 13 + [_I] * 4 + [_F, _F, _P],
        "prpe_layernorm_f32": [_P] * 4 + [_I, _I, _F, _P],
        "prpe_layernorm_bf16": [_P] * 4 + [_I, _I, _F, _P],
        "prpe_linear_f32": [_P] * 5 + [_I] * 3 + [_P],
        "prpe_linear_bf16": [_P] * 5 + [_I] * 3 + [_P],
    },
    "bn_act": {
        "prpe_bn_act_f32": [_P] * 6 + [_I] * 5 + [_P],
        "prpe_bn_act_bf16": [_P] * 6 + [_I] * 5 + [_P],
    },
    "ms_deform_attn": {
        "prpe_msda_f32": [_P] * 5 + [_I] * 8 + [_P],
        "prpe_msda_bf16": [_P] * 5 + [_I] * 8 + [_P],
    },
}

# one counter per kernel route; ``mhsa`` and ``mhsa_bhtd`` share a library,
# and so do ``ln_mhsa`` and its stages alone (``layernorm``, ``linear``);
# ``bn_act`` is eval BatchNorm with its activation, ``bn_act_residual`` the
# share of those launches that also add a residual, ``msda`` multi-scale
# deformable attention
launches: Dict[str, int] = {
    name: 0 for name in ("nms", "mhsa", "mhsa_bhtd", "ln_mhsa", "layernorm", "linear", "bn_act",
                         "bn_act_residual", "msda")}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
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
    """Build every kernel source, one nvcc per source, all started together.

    Returns the compiler's output per source (registers, shared memory and
    spills from ``-Xptxas -v``); empty for a library that was already built.
    """
    procs = {name: _start(name) for name in SIGNATURES}
    return {name: _finish(name, proc) for name, proc in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        for sym, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
