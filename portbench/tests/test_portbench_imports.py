"""Nothing of the benchmark imports JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` begins with ``repro``),
and the reference imports nothing of the program either."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PB = ROOT / "portbench"


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert names <= {"__future__", "heapq", "collections", "typing",
                     "numpy", "portbench"}, names


def test_no_jax_in_sys_modules_after_a_rehearsal():
    """A whole CPU run of a cell in a fresh interpreter, then its
    ``sys.modules``."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from portbench.tests.helpers import small_cell, cpu_run\n"
        "from portbench import harness\n"
        "r = cpu_run(small_cell('cholesky512_sweep_warm'))\n"
        "print(json.dumps({'forbidden': harness.forbidden_modules(),"
        " 'mods': sorted({m.split('.')[0] for m in sys.modules}),"
        " 'correct': r['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == [] and got["correct"]
    assert not set(got["mods"]) & FORBIDDEN
    assert "repro_torch" in got["mods"]
