"""What the benchmark may import and read: nothing of JAX or the JAX
package anywhere under benchmark/ (top-level names compared whole, since
rmcl_tpu_torch begins with rmcl_tpu), nothing of the program in the
reference, and none of the JAX era's scripts and records."""

from __future__ import annotations

import ast

from benchmark.tests.conftest import ROOT

BENCH_DIR = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "rmcl_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources():
    return [p for p in BENCH_DIR.rglob("*.py") if "cache" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = JAX & set(_imports(path))
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert "rmcl_tpu_torch" not in set(_imports(path)), path


def test_nothing_reads_the_jax_era_files():
    for path in _sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for name in ("chip_smoke", "BENCH_", "scripts/", "bench.py", "VERDICT"):
            assert name not in text, f"{path} names {name}"
