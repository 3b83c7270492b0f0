"""The ctypes bindings that the wrappers declare (``_build.libraries``)
against the C entry points in ``prpe_tpu_torch/csrc/*.cu``: every ``extern
"C"`` function has a signature with the same arguments, in kind and number,
and the reverse; every source has a declaration. No compiler runs here, so
this is the one check of a new entry point before the card."""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from prpe_tpu_torch.ops.kernels import _build
from torch_one_thread import torch_on_one_thread  # noqa: F401

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def _kind(param: str):
    """The ctypes type a C parameter is bound with."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.split()
    return {"int": ctypes.c_int, "float": ctypes.c_float}[words[-2] if len(words) > 1 else words[0]]


def entry_points(lib: str):
    source = _COMMENT.sub("", (_build.CSRC / f"{lib}.cu").read_text())
    return {name: [_kind(p) for p in params.split(",")]
            for name, params in _ENTRY.findall(source)}


def test_every_source_has_signatures():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sources == sorted(_build.libraries)


@pytest.mark.parametrize("lib", sorted(_build.libraries))
def test_signatures_match_sources(lib):
    found = entry_points(lib)
    declared = _build.libraries[lib].entry_points
    assert found, f"csrc/{lib}.cu exports no extern \"C\" entry point"
    assert sorted(found) == sorted(declared)
    for name, kinds in found.items():
        assert list(declared[name]) == kinds, name


def test_import_declares_every_route_at_zero():
    """In a fresh interpreter, importing the kernel package declares every
    library and leaves ``launches`` with each declared route at 0, so that a
    reader's snapshot of ``launches`` holds every key it will later see."""
    out = subprocess.run(
        [sys.executable, "-c", "import json, prpe_tpu_torch.ops.kernels as k; print(json.dumps("
         "[k.launches, {n: l.routes for n, l in k._build.libraries.items()}]))"],
        capture_output=True, text=True, check=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1]).stdout
    launches, routes = json.loads(out)
    assert sorted(routes) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    declared = [r for rs in routes.values() for r in rs]
    assert len(declared) == len(set(declared))
    assert launches == {r: 0 for r in declared}


def test_parser_reads_a_signature():
    """The parser itself, on the kinds of parameters the sources use."""
    kinds = [_kind(p) for p in "const void* x, void *out, int rows, float eps".split(",")]
    assert kinds == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
