"""Nothing the benchmark runs imports JAX or the JAX package (top-level names
compared whole, since ``prpe_tpu_torch`` begins with ``prpe_tpu``), and the
reference imports nothing of ``prpe_tpu_torch``."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import REPO

BENCH = REPO / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import_in_source(path):
    assert not set(_imports(path)) & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "prpe_tpu_torch" not in set(_imports(path))


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "prpe_tpu_torch_like", object())
    assert "prpe_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "prpe_tpu.nn", object())
    assert harness.forbidden_modules() == ["prpe_tpu"]


def test_a_run_loads_neither_jax_nor_the_reference_loads_the_port():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.cascade, benchmark.reference.judge, benchmark.reference.flops\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'prpe_tpu_torch'], 'port'\n"
        "from benchmark import harness, weights\n"
        "mod = harness.load_module(harness.ROOT / 'benchmark/drivers/cascade.py', 'd')\n"
        "import prpe_tpu_torch.infer.cascade\n"
        "print(harness.forbidden_modules())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
