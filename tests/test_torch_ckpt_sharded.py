"""Port parity: erasure-coded checkpoints of a sharded train state.

The reference (a subprocess with 8 XLA CPU devices) lays its initial train
state out under ``fsdp`` on a ``(data 2, model 4)`` and a ``(pod 2, data 2,
model 2)`` mesh with the dry run's shardings and saves it with its
``CheckpointManager`` (DRC(9,6,3)): ``np.asarray`` assembles each sharded
leaf.  The port runs ``model_run.Case(kind="train", mode="fsdp",
checkpoint=True, steps=0)`` on the same parameters in ONE spawn of 8 ``gloo``
CPU ranks: every rank saves the DTensor state together (rank 0 gathers each
leaf and writes), one uninterrupted step runs, ``node_2.bin`` is deleted,
the state is loaded back into the layout through the layered repair and the
same step runs again.  Exact equality throughout:

* the sharded save's ``meta.json`` and its surviving ``node_<i>.bin`` equal
  the reference's, byte for byte, and its CRCs equal a one-process encode of
  the state gathered to rank 0;
* every rank's restored blocks equal its saved ones, bit for bit, with the
  same report (``repair`` of node 2) on every rank;
* the resumed step's loss and norm equal the uninterrupted step's;
* the reference restores the port's damaged directory to the arrays it
  restores from its own whole one.
"""
import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.train import checkpoint as rck

from repro_torch.dist import model_run

import mesh_reference as mr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_BASE = dict(kind="train", mode="fsdp", batch=4, seq=32, smoke=True, param_dtype="float32",
             steps=0, checkpoint=True, xent_tile=64)
CASES = [
    ("starcoder_2x4", model_run.Case("starcoder2-3b", mesh=(2, 4), **_BASE)),
    ("starcoder_2x2x2", model_run.Case("starcoder2-3b", mesh=(2, 2, 2), **_BASE)),
    ("dbrx_2x4", model_run.Case("dbrx-132b", mesh=(2, 4), capacity_factor=8.0, **_BASE)),
    ("dbrx_2x2x2", model_run.Case("dbrx-132b", mesh=(2, 2, 2), capacity_factor=8.0, **_BASE)),
]
NAMES = [name for name, _ in CASES]
STEP = model_run.TRAIN_WARMUP  # the state saved after 0 steps


def _reference(d):
    spec = [{"name": name, "arch": mr.ARCHS[case.arch], "mode": case.mode,
             "mesh": list(case.mesh), "cf": case.capacity_factor, "sharding": None,
             "state_dtype": model_run.train_config(case).optimizer.state_dtype}
            for name, case in CASES]
    mr.run_reference(f"""
        from repro.launch.dryrun import _named
        from repro.models import backbone
        from repro.train.checkpoint import CheckpointManager
        from repro.train.optimizer import AdamWConfig, init_opt_state, opt_state_axes
        d = {d!r}
        for case in json.loads({json.dumps(json.dumps(spec))}):
            cfg = case_config(case)
            mesh = make_mesh(case["mesh"])
            params, paxes = backbone.init_model(jax.random.key(0), cfg)
            np.savez(f"{{d}}/{{case['name']}}_params.npz", **flat(params))
            opt = init_opt_state(params, AdamWConfig(state_dtype=case["state_dtype"]))
            rules = make_rules(case["mode"], multi_pod=len(case["mesh"]) == 3)
            with axis_rules(rules), jax.set_mesh(mesh):
                params = jax.device_put(params, _named(mesh, paxes, params))
                opt = jax.device_put(opt, _named(mesh, opt_state_axes(paxes), opt))
            assert len(jax.tree.leaves(params)[0].sharding.device_set) == 8
            CheckpointManager(f"{{d}}/ref_{{case['name']}}").save({STEP},
                                                                  {{"params": params, "opt": opt}})
        print("OK")
    """)


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as d:
        _reference(d)
        cases = []
        for name, case in CASES:
            with np.load(os.path.join(d, f"{name}_params.npz")) as f:
                arrays = mr.port_arrays(model_run.case_config(case), dict(f))
            path = os.path.join(d, f"{name}_port.npz")
            np.savez(path, **arrays)
            cases.append(dataclasses.replace(case, params=path))
        rows = model_run.run(cases, workdir=os.path.join(d, "run"), device="cpu")
        yield {name: (case, row, os.path.join(d, f"ref_{name}", f"step_{STEP:08d}"))
               for (name, case), row in zip(CASES, rows)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", NAMES)
def test_sharded_save_equals_reference_files(runs, name):
    _, row, ref_dir = runs[name]
    ck = row["ranks"][0]["checkpoint"]
    port_dir = os.path.join(ck["ckpt_dir"], f"step_{STEP:08d}")
    assert _read(os.path.join(port_dir, "meta.json")) == _read(os.path.join(ref_dir, "meta.json"))
    survivors = sorted(os.listdir(port_dir))
    assert "node_2.bin" not in survivors and len(survivors) == 9
    for fname in survivors:
        assert _read(os.path.join(port_dir, fname)) == _read(os.path.join(ref_dir, fname)), fname


@pytest.mark.parametrize("name", NAMES)
def test_sharded_save_equals_one_process_encode(runs, name):
    _, row, ref_dir = runs[name]
    ck = row["ranks"][0]["checkpoint"]
    assert ck["crcs"] == ck["crcs_one_process"]
    with open(os.path.join(ref_dir, "meta.json")) as f:
        assert ck["crcs"] == json.load(f)["crcs"]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_load_restores_every_rank_s_blocks(runs, name):
    _, row, _ = runs[name]
    reports = set()
    for rank in row["ranks"]:
        ck = rank["checkpoint"]
        assert ck["restored_equal"], rank["rank"]
        assert ck["step"] == STEP and ck["mode"] == "repair" and ck["repaired_nodes"] == [2]
        reports.add((ck["mode"], ck["cross_rack_blocks"], ck["inner_rack_blocks"]))
    assert len(reports) == 1


@pytest.mark.parametrize("name", NAMES)
def test_resumed_step_equals_uninterrupted(runs, name):
    _, row, _ = runs[name]
    for rank in row["ranks"]:
        ck = rank["checkpoint"]
        assert ck["resumed"] == ck["uninterrupted"]
        assert np.isfinite(ck["resumed"]["loss"])


@pytest.mark.parametrize("name", NAMES)
def test_reference_restores_the_sharded_save(runs, name):
    """The reference loads the port's directory (node 2 lost: the layered
    repair) to the arrays it loads from its own whole directory."""
    _, row, ref_dir = runs[name]
    with open(os.path.join(ref_dir, "meta.json")) as f:
        meta = json.load(f)
    like = [jnp.zeros(m["shape"], m["dtype"]) for m in meta["leaves"]]
    want, _, _ = rck.CheckpointManager(os.path.dirname(ref_dir)).load(like)
    got, step, report = rck.CheckpointManager(row["ranks"][0]["checkpoint"]["ckpt_dir"]).load(like)
    assert step == STEP and report.mode == "repair"
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))
