"""The reference imports nothing of JAX, the JAX package or the port; the
harness imports nothing of JAX or the JAX package."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "octree_raymarcher_tpu"}


def _top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_reference_sources_import_only_torch_numpy_and_themselves():
    for path in (BENCH / "reference").glob("*.py"):
        assert _top_names(path) <= {"__future__", "dataclasses", "typing", "math", "numpy",
                                    "torch"}, path


def test_reference_loads_no_port_and_no_jax():
    code = ("import sys, pkgutil, importlib, benchmark.reference as r; "
            "[importlib.import_module('benchmark.reference.' + m.name) "
            "for m in pkgutil.iter_modules(r.__path__)]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(eval(out.stdout))
    assert not loaded & (JAX_SIDE | {"octree_raymarcher_tpu_torch"}), loaded


def test_harness_imports_no_jax_side_module():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _top_names(path) & JAX_SIDE, path
