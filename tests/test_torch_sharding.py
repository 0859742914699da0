"""Port parity: the sharding rules, the parameters' logical axes and their
layout over a mesh.

``repro_torch.dist.sharding.resolve_spec`` must give the reference's
``PartitionSpec`` entries on the reference's own cases
(``tests/test_dist.py``) and on every case hypothesis draws as
``tests/test_dist_properties.py`` draws them; ``param_axes`` must be the
reference's ``init_model`` axes tree under the port's parameter names for
every architecture; the block of every parameter that each device holds
must be the reference's ``NamedSharding(mesh, spec).devices_indices_map``
block (computed in a subprocess with 8 XLA CPU devices), for every mode and
``multi_pod``, both as ``local_slices`` computes it and as ``shard_model``
lays the parameters out over 8 ``gloo`` ranks.
"""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import warnings

import jax
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro import configs as rconfigs
from repro.dist import sharding as rsh
from repro.models import backbone as rbb
from repro.models.common import LOGICAL as RLOGICAL

from repro_torch import configs as tconfigs
from repro_torch.dist import sharding as tsh
from repro_torch.models import backbone as tbb
from repro_torch.models import common as tcommon
from repro_torch.models.weights import param_axes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {"data": 2, "model": 4}
POD_MESH = {"pod": 2, "data": 2, "model": 2}
STACKED = ("blocks", "mamba_main", "mamba_rem", "encoder")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _ref(names, shape, mesh_shape, mode="tp", multi_pod=False, table=None):
    rules = rsh.Rules("none", False, table) if table is not None else rsh.make_rules(
        mode, multi_pod=multi_pod)
    return tuple(rsh.resolve_spec(names, shape, FakeMesh(mesh_shape), rules))


def _port(names, shape, mesh_shape, mode="tp", multi_pod=False, table=None):
    rules = tsh.Rules("none", False, table) if table is not None else tsh.make_rules(
        mode, multi_pod=multi_pod)
    return tsh.resolve_spec(names, shape, FakeMesh(mesh_shape), rules)


# the cases of tests/test_dist.py, with the entries it expects
DIST_CASES = [
    # kv=8 heads cannot shard 16 ways -> replicated
    (("batch", None, "kv", None), (256, 1, 8, 128), {"data": 16, "model": 16}, "tp", False,
     None, ("data", None, None, None)),
    (("vocab", "embed"), (256000, 8192), {"data": 16, "model": 16}, "tp", False, None,
     ("model", None)),
    # seq takes model first; heads must not reuse it
    (("batch", "seq", "heads", None), (256, 4096, 64, 128), {"data": 16, "model": 16},
     "tp_sp", False, None, ("data", "model", None, None)),
    (("embed", "ffn"), (8192, 22528), {"data": 16, "model": 16}, "fsdp", False, None,
     ("data", "model")),
    (("batch", "embed"), (64, 64), {"data": 4, "model": 4}, None, False, {}, (None, None)),
    (("made_up", "batch"), (64, 64), {"data": 4, "model": 4}, "tp", False, None,
     (None, "data")),
    (("embed", "ffn"), (64, 64), {"data": 1, "model": 4}, "fsdp", False, None,
     (None, "model")),
    (("batch", "ffn"), (64, 64), {"pod": 2, "data": 4, "model": 4}, "tp", True, None,
     (("pod", "data"), "model")),
]


@pytest.mark.parametrize("names,shape,mesh,mode,multi_pod,table,want", DIST_CASES)
def test_resolve_spec_matches_reference_cases(names, shape, mesh, mode, multi_pod, table, want):
    got = _port(names, shape, mesh, mode, multi_pod, table)
    assert got == want
    assert got == _ref(names, shape, mesh, mode, multi_pod, table)


def test_resolve_spec_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError):
        tsh.resolve_spec(("batch",), (4, 4), FakeMesh({"data": 2}), tsh.make_rules("tp"))
    with pytest.raises(ValueError):
        tsh.make_rules("3d")
    rules = tsh.make_rules("tp", multi_pod=True)
    assert rules.mesh_axes("batch") == ("pod", "data") == rsh.make_rules(
        "tp", multi_pod=True).mesh_axes("batch")
    assert tsh.MODES == rsh.MODES
    assert tcommon.LOGICAL == RLOGICAL


def test_rule_context_and_ambient_mesh():
    assert tsh.current_rules().mode == "tp"
    assert tsh.ambient_mesh() is None
    mesh = FakeMesh(MESH)
    with tsh.axis_rules(tsh.make_rules("fsdp")) as rules:
        assert tsh.current_rules() is rules
        with tsh.use_mesh(mesh):
            assert tsh.ambient_mesh() is mesh
            x = torch.ones(4, 4)
            assert tsh.logical_constraint(x, ("batch", "embed")) is x  # a plain tensor stays
        assert tsh.ambient_mesh() is None
    assert tsh.current_rules().mode == "tp"


def test_rules_without_a_mesh_warn_once_and_leave_x(monkeypatch):
    monkeypatch.setattr(tsh, "_WARNED_NO_MESH", [False])
    x = torch.ones(2, 3)
    with tsh.axis_rules(tsh.make_rules("tp")):
        with pytest.warns(RuntimeWarning, match="no ambient mesh"):
            assert tcommon.constrain(x, "batch", "embed") is x
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tcommon.constrain(x, "batch", "embed") is x
    assert tcommon.constrain(x, "batch", "embed") is x  # no rules, no mesh: silent


try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # the property test needs hypothesis, as the reference's
    given = None

if given is not None:
    MESH_SHAPES = (
        {"data": 4, "model": 8},
        {"pod": 2, "data": 4, "model": 4},
        {"data": 16, "model": 16},
        {"data": 3, "model": 5},
        {"data": 1, "model": 4},
    )
    DIM_SIZES = (1, 2, 3, 8, 15, 24, 64, 240)

    @settings(max_examples=200, deadline=None)
    @given(
        mode=st.sampled_from(rsh.MODES),
        multi_pod=st.booleans(),
        mesh_shape=st.sampled_from(MESH_SHAPES),
        dims=st.lists(
            st.tuples(st.sampled_from(RLOGICAL + (None,)), st.sampled_from(DIM_SIZES)),
            min_size=1,
            max_size=4,
        ),
    )
    def test_resolve_spec_equals_reference_on_drawn_cases(mode, multi_pod, mesh_shape, dims):
        names = tuple(name for name, _ in dims)
        shape = tuple(size for _, size in dims)
        assert _port(names, shape, mesh_shape, mode, multi_pod) == _ref(
            names, shape, mesh_shape, mode, multi_pod)


# ----------------------------------------------------------- parameter axes
def _reference_axes(arch):
    """The reference's init_model axes tree, flattened through the port's
    name map: a stacked layer's leading None dropped, one entry a layer."""
    cfg = rconfigs.get_smoke(arch)
    params, axes = rbb.init_model(jax.random.key(0), cfg)
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, f"{prefix}{key}.")
        elif isinstance(tree, list):
            for i, sub in enumerate(tree):
                walk(sub, f"{prefix}{i}.")
        else:
            out[prefix[:-1]] = tuple(tree)

    walk(axes, "")
    flat = {}
    for name, ax in out.items():
        stack, _, rest = name.partition(".")
        if stack in STACKED and isinstance(axes[stack], dict):
            assert ax[0] is None
            for i in range(jax.tree.leaves(params[stack])[0].shape[0]):
                flat[f"{stack}.{i}.{rest}"] = ax[1:]
        else:
            flat[name] = ax
    return flat


@pytest.mark.parametrize("arch", rconfigs.list_archs())
def test_param_axes_equal_reference_init_model_axes(arch):
    model = tbb.Backbone(tconfigs.get_smoke(arch), device="meta")
    got = {name: tuple(ax) for name, ax in param_axes(model).items()}
    assert got == _reference_axes(arch)
    assert all(isinstance(ax, tcommon.AxisSpec) for ax in param_axes(model).values())


# ------------------------------------------------------- per-device blocks
SLICE_ARCHS = ("starcoder2-3b", "dbrx-132b")
LAYOUTS = [(mode, False) for mode in tsh.MODES] + [("tp", True), ("fsdp_sp", True)]


def _reference_blocks():
    """The reference's devices_indices_map of every smoke parameter of
    SLICE_ARCHS, per layout: {arch: {layout: {name: {coord: [[start, stop]...]}}}}."""
    code = f"""
        import json, jax, numpy as np
        from jax.sharding import NamedSharding
        from repro import configs
        from repro.dist.sharding import make_rules, resolve_spec
        from repro.models import backbone
        out = {{}}
        for arch in {list(SLICE_ARCHS)!r}:
            params, axes = backbone.init_model(jax.random.key(0), configs.get_smoke(arch))
            shapes = {{}}
            def walk(p, a, prefix):
                if isinstance(p, dict):
                    for k in p:
                        walk(p[k], a[k], prefix + k + ".")
                else:
                    stack = prefix.split(".")[0]
                    if stack == "blocks":
                        for i in range(p.shape[0]):
                            rest = prefix[len(stack) + 1:-1]
                            shapes[f"blocks.{{i}}.{{rest}}"] = (tuple(a[1:]), p.shape[1:])
                    else:
                        shapes[prefix[:-1]] = (tuple(a), p.shape)
            walk(params, axes, "")
            out[arch] = {{}}
            for mode, pod in {LAYOUTS!r}:
                shape, names = ((2, 4), ("data", "model"))
                if pod:
                    shape, names = ((2, 2, 2), ("pod", "data", "model"))
                auto = (jax.sharding.AxisType.Auto,) * len(shape)
                mesh = jax.make_mesh(shape, names, axis_types=auto)
                coord = {{d.id: idx for idx, d in np.ndenumerate(mesh.devices)}}
                rules = make_rules(mode, multi_pod=pod)
                blocks = {{}}
                for name, (ax, shp) in shapes.items():
                    spec = resolve_spec(ax, shp, mesh, rules)
                    m = NamedSharding(mesh, spec).devices_indices_map(shp)
                    blocks[name] = {{
                        ",".join(map(str, coord[d.id])): [
                            [s.start or 0, shp[i] if s.stop is None else s.stop]
                            for i, s in enumerate(sl)]
                        for d, sl in m.items()}}
                out[arch][f"{{mode}}{{'+pod' if pod else ''}}"] = blocks
        print(json.dumps(out))
    """
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference_blocks():
    return _reference_blocks()


def _layout_mesh(layout):
    pod = layout.endswith("+pod")
    names = ("pod", "data", "model") if pod else ("data", "model")
    sizes = POD_MESH if pod else MESH
    return layout.removesuffix("+pod"), pod, names, sizes


def test_local_slices_equal_reference_device_blocks(reference_blocks):
    checked = 0
    for arch in SLICE_ARCHS:
        model = tbb.Backbone(tconfigs.get_smoke(arch), device="meta")
        axes = param_axes(model)
        shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
        for layout, blocks in reference_blocks[arch].items():
            mode, pod, names, sizes = _layout_mesh(layout)
            rules = tsh.make_rules(mode, multi_pod=pod)
            assert blocks.keys() == shapes.keys()
            for name, by_coord in blocks.items():
                spec = tsh.resolve_spec(axes[name], shapes[name], FakeMesh(sizes), rules)
                for key, want in by_coord.items():
                    coord = dict(zip(names, map(int, key.split(","))))
                    got = tsh.local_slices(spec, shapes[name], sizes, coord)
                    assert [[s.start, s.stop] for s in got] == want, (arch, layout, name, key)
                    checked += 1
    assert checked > 1000


def _shard_worker(rank, world, init_file, blocks_file, out_dir):
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models.weights import shard_model

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        torch.set_num_threads(1)
        with open(blocks_file) as f:
            reference = json.load(f)
        bad = []
        for arch in SLICE_ARCHS:
            cfg = tconfigs.get_smoke(arch)
            gen = torch.Generator().manual_seed(0)
            full = {name: p.clone() for name, p in
                    tbb.init_model(cfg, generator=gen, device="cpu").named_parameters()}
            for layout, blocks in reference[arch].items():
                mode, pod, names, sizes = _layout_mesh(layout)
                mesh = make_model_mesh(tuple(sizes.values()), names, device_type="cpu")
                model = tbb.init_model(cfg, generator=torch.Generator().manual_seed(0),
                                       device="cpu")
                shard_model(model, mesh, tsh.make_rules(mode, multi_pod=pod))
                key = ",".join(map(str, mesh.get_coordinate()))
                for name, p in model.named_parameters():
                    want = full[name][tuple(slice(a, b) for a, b in blocks[name][key])]
                    if not torch.equal(p.to_local(), want):
                        bad.append((arch, layout, name, "local"))
                    if not torch.equal(p.full_tensor(), full[name]):
                        bad.append((arch, layout, name, "full"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(bad, f)
    finally:
        dist.destroy_process_group()


def test_shard_model_blocks_equal_reference_device_blocks(reference_blocks):
    with tempfile.TemporaryDirectory() as d:
        blocks_file = os.path.join(d, "blocks.json")
        with open(blocks_file, "w") as f:
            json.dump(reference_blocks, f)
        mp.start_processes(_shard_worker,
                           args=(8, os.path.join(d, "pg_init"), blocks_file, d),
                           nprocs=8, join=True, start_method="spawn")
        for rank in range(8):
            with open(os.path.join(d, f"rank{rank}.json")) as f:
                assert json.load(f) == [], rank


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 4)

    assert tsh.placements(("data", None, "model"), Mesh()) == (Shard(0), Shard(2))
    assert tsh.placements((None, "model"), Mesh()) == (Replicate(), Shard(1))
    assert tsh.placements((None, None), Mesh()) == (Replicate(), Replicate())
    # tp2d: ("model", "data") is model-major, against the mesh's data-major order
    got = tsh.placements((("model", "data"), None), Mesh())
    assert got == (_StridedShard(0, split_factor=4), Shard(0))


def test_resolve_specs_walks_a_tree_of_parameters():
    model = tbb.Backbone(tconfigs.get_smoke("dbrx-132b"), device="meta")
    axes = param_axes(model)
    params = dict(model.named_parameters())
    tree = {"params": axes, "stacked": [axes["embed.w"], axes["ln_f.scale"]]}
    shapes = {"params": params, "stacked": [params["embed.w"].shape, params["ln_f.scale"].shape]}
    got = tsh.resolve_specs(tree, shapes, FakeMesh(MESH), tsh.make_rules("tp"))
    want = {name: _ref(ax, tuple(params[name].shape), MESH) for name, ax in axes.items()}
    assert got["params"] == want
    assert got["stacked"] == [want["embed.w"], want["ln_f.scale"]]
