"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole, so ``openmg_tpu_torch`` passes and ``openmg_tpu`` does
not); the reference nothing of the program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from omgbench import harness
from omgbench.conftest import REPO

PROGRAM = "openmg_tpu_torch"


def loaded_after(code, cwd=REPO):
    """Top-level names of ``sys.modules`` after ``code`` in a fresh
    interpreter."""
    code += "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd, stdout=subprocess.PIPE,
                       text=True, timeout=300, check=True)
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_the_names_are_compared_whole(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "openmg_tpu_torch.core", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "openmg_tpu.core", object())
    assert harness.forbidden_loaded() == ["openmg_tpu"]


def test_a_whole_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    names = loaded_after(
        "from omgbench import harness, spec, run\n"
        f"root = {str(tiny_root)!r}\n"
        "b = spec.load(root)\n"
        "for m in b['end_to_end'] + b['per_layer']:\n"
        "    spec.module('metrics', m['name'], root)\n"
        "for name in ('poisson3d-256.single', 'diffusion3d-256.single', 'poisson3d-256.batch8'):\n"
        "    harness.run_cell(b, name, 1, 0.1, True, 'cpu', root=root)\n")
    assert PROGRAM in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after(
        "from omgbench import spec\n"
        "for kind in ('poisson', 'diffusion'):\n"
        "    spec.module('reference', kind)\n")
    assert not names & ({PROGRAM} | set(harness.FORBIDDEN))
    for path in (REPO / "omgbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= {"__future__", "torch", "numpy", "omgbench"}, (path, tops)
