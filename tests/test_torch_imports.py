"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_modules_are_found():
    names = _port_modules()
    for must in ("repro_torch.kernels.gf_matmul", "repro_torch.dist.collectives",
                 "repro_torch.train.checkpoint", "repro_torch.core.codes.msr_clay"):
        assert must in names


def test_importing_every_port_module_pulls_in_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {**os.environ, "PYTHONPATH": SRC}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_no_jax_and_no_repro():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("path", sorted(
    os.path.join(dirpath, f)
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch"))
    for f in files if f.endswith(".py")
), ids=lambda p: os.path.relpath(p, SRC))
def test_port_sources_import_no_jax_and_no_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
