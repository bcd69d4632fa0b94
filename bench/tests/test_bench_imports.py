"""Nothing the harness loads is JAX or the JAX package.

Names are compared by their top-level part, whole: ``repro_torch`` (the
port) is allowed, ``repro`` (the JAX package) is not.
"""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from bench import harness

BENCH = Path(harness.__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _harness_files() -> list[Path]:
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def test_harness_sources_import_no_jax():
    for path in _harness_files():
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert _imports(path) <= {"__future__", "dataclasses", "math", "typing", "numpy",
                                  "torch"}, path


def test_a_run_loads_no_jax_module(tmp_path):
    """Run each tiny cell in a fresh process, load every metric reader, and
    list the top-level names of every module the process then holds."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import torch
from bench import harness
from bench.tests import tiny
for name in tiny.TINY:
    cell = tiny.tiny(harness.load_cell(name, harness.BENCH.parent))
    harness.run(cell, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
for p in sorted((harness.BENCH / "metrics").glob("*.py")):
    harness.load_module(harness.BENCH, "metrics", p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
