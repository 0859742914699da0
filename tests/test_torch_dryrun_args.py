"""The dry run's argument bytes equal the reference's, for every
architecture's full config x its applicable shapes x the orchestrator's cell
rules x both production meshes (16 x 16 and 2 x 16 x 16).

The reference runs in a subprocess with 512 XLA CPU devices, as its dry run
does: ``jax.eval_shape`` of its train (and decode) state, nothing allocated,
and per leaf the bytes of ``NamedSharding(mesh, spec).shard_shape`` under
the cell's rules, summed over the parameters, the optimizer state (train),
the decode state (decode) and the batch on its dry run's batch axes; also
its ``model_flops_global``.  The port builds each cell's state as fake
tensors laid out over the same mesh of a ``fake`` process group
(``dryrun.build_cell``) and sums rank 0's local bytes
(``Cell.argument_bytes``): the two sums must be equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs as tconfigs
from repro_torch.dist.sharding import make_rules
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.orchestrate_dryrun import cell_rules
from repro_torch.models.config import SHAPES
from torch_groups import no_process_group_left  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(mesh, arch, shape) for mesh in ("single", "multi") for arch in tconfigs.ARCHS
         for shape in tconfigs.applicable_shapes(tconfigs.get_config(arch))]

REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json, math
import jax
from repro.configs import ARCHS, applicable_shapes, get_config, input_specs
from repro.dist.sharding import axis_rules, make_rules
from repro.launch import dryrun as dr
from repro.launch.mesh import make_production_mesh
from repro.launch.orchestrate_dryrun import cell_rules
from repro.models.common import spec as axspec
from repro.models.config import SHAPES
from repro.train import TrainConfig
from repro.train.optimizer import AdamWConfig, opt_state_axes

def shard_bytes(mesh, axes, shapes):
    named = dr._named(mesh, axes, shapes)
    leaves = jax.tree.leaves(named, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
    return sum(math.prod(sh.shard_shape(x.shape)) * x.dtype.itemsize
               for sh, x in zip(leaves, jax.tree.leaves(shapes)))

out = {}
for mesh_name in ("single", "multi"):
    mp = mesh_name == "multi"
    mesh = make_production_mesh(multi_pod=mp)
    for arch in ARCHS:
        cfg = get_config(arch)
        tcfg = TrainConfig(optimizer=AdamWConfig(state_dtype=cfg.opt_state_dtype))
        for shape_name in applicable_shapes(cfg):
            shape = SHAPES[shape_name]
            batch = input_specs(cfg, shape)
            with axis_rules(make_rules(cell_rules(arch, shape_name), multi_pod=mp)), \\
                    jax.set_mesh(mesh):
                ps, os_, pax = dr.abstract_train_state(cfg, tcfg)
                total = shard_bytes(mesh, pax, ps)
                if shape.kind == "train":
                    total += shard_bytes(mesh, opt_state_axes(pax), os_)
                if shape.kind == "decode":
                    ss, sax = dr.abstract_decode_state(cfg, shape.global_batch, shape.seq_len)
                    total += shard_bytes(mesh, sax, ss)
                    total += shard_bytes(mesh, {"t": axspec("batch", None)},
                                         {"t": batch["tokens"]})
                else:
                    total += shard_bytes(mesh, dr._batch_axes(batch), batch)
            out[f"{mesh_name}|{arch}|{shape_name}"] = {
                "args": total, "model_flops": dr.model_flops_global(cfg, shape, shape.kind)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE)],
                          capture_output=True, text=True, env=env, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh,arch,shape", CELLS)
def test_argument_bytes_equal_reference(reference, mesh, arch, shape):
    want = reference[f"{mesh}|{arch}|{shape}"]
    multi = mesh == "multi"
    cfg = tconfigs.get_config(arch)
    rules = make_rules(cell_rules(arch, shape), multi_pod=multi)
    with fake_world(512 if multi else 256, 0):
        pmesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            cell = dryrun.build_cell(cfg, SHAPES[shape], pmesh, rules,
                                     dryrun.train_config(cfg), "cpu")
            got = cell.argument_bytes(pmesh, rules)
    assert got == want["args"]
    assert dryrun.model_flops_global(cfg, SHAPES[shape], SHAPES[shape].kind) == \
        want["model_flops"]
