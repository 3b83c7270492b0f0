"""The ctypes bindings in ``_build.SIGNATURES`` against the C entry points in
``prpe_tpu_torch/csrc/*.cu``: every ``extern "C"`` function has a signature
with the same arguments, in kind and number, and the reverse; every source
has an entry. No compiler runs here, so this is the one check of a new entry
point before the card."""

import ctypes
import re

import pytest

from prpe_tpu_torch.ops.kernels import _build

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
    assert sources == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("lib", sorted(_build.SIGNATURES))
def test_signatures_match_sources(lib):
    found = entry_points(lib)
    assert found, f"csrc/{lib}.cu exports no extern \"C\" entry point"
    assert sorted(found) == sorted(_build.SIGNATURES[lib])
    for name, kinds in found.items():
        assert _build.SIGNATURES[lib][name] == kinds, name


def test_parser_reads_a_signature():
    """The parser itself, on the kinds of parameters the sources use."""
    kinds = [_kind(p) for p in "const void* x, void *out, int rows, float eps".split(",")]
    assert kinds == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
