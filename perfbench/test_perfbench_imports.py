"""The import guard: nothing the benchmark runs imports JAX or the JAX
package ``repro``, compared by whole top-level names (``repro_torch`` is the
program, not ``repro``); the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in spec.HERE.rglob("*.py")
                 if not p.name.startswith("test_") and p.name != "conftest.py")


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".", 1)[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(spec.HERE)))
def test_module_imports_no_jax_nor_the_jax_package(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imported(path)
    assert not _imported(path) & FORBIDDEN


def test_a_run_loads_no_jax_module():
    code = (
        "import sys\n"
        "from perfbench import harness, run\n"
        "harness.run_cell('drc_9_6_3.node_recovery', 7, 0.2, True, device='cpu',\n"
        "    overrides={'config': {'sub_bytes': 128}, 'mix': {'pool_stripes': 2}})\n"
        "print(','.join(run.forbidden_modules()) or 'clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                          text=True, timeout=300, check=True)
    assert proc.stdout.strip().splitlines()[-1] == "clean"
