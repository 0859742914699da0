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
                 "repro_torch.train.checkpoint", "repro_torch.core.codes.msr_clay",
                 "repro_torch.kernels.flash_attention", "repro_torch.models.backbone",
                 "repro_torch.serve.engine", "repro_torch.kernels.flash_ablation",
                 "repro_torch.kernels.gf_ablation", "repro_torch.core.multi_failure",
                 "repro_torch.train.fault_tolerance", "repro_torch.storage.simulator",
                 "repro_torch.storage.costmodel", "repro_torch.core.analysis.bandwidth",
                 "repro_torch.core.analysis.reliability", "repro_torch.launch.mesh",
                 "repro_torch.dist.mesh_run", "repro_torch.dist.spmd_ablation",
                 "repro_torch.train.schedule", "repro_torch.train.optimizer",
                 "repro_torch.train.xent", "repro_torch.train.data",
                 "repro_torch.train.train_step", "repro_torch.launch.train",
                 "repro_torch.examples.train_e2e", "repro_torch.examples.elastic_recovery",
                 "repro_torch.models.mamba2", "repro_torch.models.xlstm",
                 "repro_torch.examples.serve_demo", "repro_torch.examples.quickstart",
                 "repro_torch.examples.repair_layering", "repro_torch.dist.sharding",
                 "repro_torch.dist.mesh_collectives", "repro_torch.dist.model_run",
                 "repro_torch.dist.spawn", "repro_torch.dist.root_io",
                 "repro_torch.launch.dryrun", "repro_torch.launch.roofline_probe",
                 "repro_torch.launch.buffers", "repro_torch.launch.orchestrate_dryrun",
                 "repro_torch.check", "repro_torch.check.report", "repro_torch.check.plan",
                 "repro_torch.check.ast_rules", "repro_torch.check.__main__",
                 "repro_torch.check.lowered", "repro_torch.check.lowered.base",
                 "repro_torch.check.lowered.spmd", "repro_torch.check.lowered.shard_rules",
                 "repro_torch.check.lowered.cuda", "repro_torch.check.traced",
                 "repro_torch.check.traced.base", "repro_torch.check.traced.capture",
                 "repro_torch.check.traced.dtype_flow",
                 "repro_torch.check.traced.collectives",
                 "repro_torch.check.traced.hygiene"):
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
