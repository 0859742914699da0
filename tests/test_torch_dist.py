"""Port parity: the process-group repair executor over ``gloo``.

``repro_torch.dist.mesh_run`` spawns one process per device of the
``(pod, node)`` mesh (world sizes 6, 8, 9, 12 and 15, one spawn each) and
runs ``spmd_repair(..., mesh=make_repair_mesh(r, w))`` on every rank.  The
same data (``mesh_run.case_data``, as numpy) is encoded by the JAX package
here; for every ``REGISTRY_SWEEP`` DRC shape plus RS(9,6,3) and MSR(9,6,3),
at failed nodes 0 and n-1:

* the collector's output is byte-equal to the reference stripe's failed
  payload and to the emulated mesh's row ``target_pod * w``;
* the bytes the ranks pass to ``send`` between pods equal
  ``traffic_blocks()["cross_rack_blocks"] * alpha * sub`` (and, for DRC,
  the Eq. (3) bound ``drc_min_cross_rack_blocks``);
* the ``repair.bytes.*`` and ``repair.units_cross`` counters equal the
  reference's ``_record_schedule`` values.

A 4-stripe DRC(9,6,3) node recovery checks that relayer sets rotate, as
``tests/test_dist.py::test_spmd_node_recovery_rotates_relayers`` does.
"""
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.check.plan import REGISTRY_SWEEP
from repro.core.code_base import drc_min_cross_rack_blocks
from repro.core.codes import make_code as r_make_code
from repro.dist import collectives as rcoll

from repro_torch.core.codes import make_code
from repro_torch.dist import collectives as tcoll
from repro_torch.dist import mesh_run

SUB = 128
CODES = REGISTRY_SWEEP["DRC-f1"] + REGISTRY_SWEEP["DRC-f2"] + [("RS", 9, 6, 3),
                                                               ("MSR", 9, 6, 3)]
RECOVERY = mesh_run.Case(("DRC", 9, 6, 3), failed=0, sub=64, seed=7, stripes=4)


def _cases(world):
    cases = [mesh_run.Case(tuple(c), failed, SUB, seed=i)
             for i, c in enumerate(CODES) if c[1] == world for failed in (0, c[1] - 1)]
    return cases + ([RECOVERY] if world == 9 else [])


def _ref_stripes(case):
    code = r_make_code(*case.code)
    return [np.stack(code.encode(d)) for d in mesh_run.case_data(case, device="cpu").numpy()]


def _ref_counters(case):
    code = r_make_code(*case.code)
    with robs.tracing("ref") as tr:
        for s in range(max(1, case.stripes)):
            rcoll._record_schedule(
                rcoll.plan_to_spmd(code, code.repair_plan(case.failed, rotation=s)), case.sub)
    counters = {name: tr.counter_value(name)
                for name in ("repair.bytes.inner_rack", "repair.bytes.cross_rack")}
    counters["repair.units_cross"] = {
        str(q): tr.counter_value("repair.units_cross", pod=str(q)) for q in range(code.r)}
    return counters


@pytest.mark.parametrize("world", sorted({c[1] for c in CODES}))
def test_mesh_repair_matches_reference_and_moves_eq3_bytes(world, tmp_path):
    cases = _cases(world)
    rows = mesh_run.run(cases, workdir=str(tmp_path), save=True, device="cpu")
    for i, (case, row) in enumerate(zip(cases, rows)):
        label = f"{case.code} failed {case.failed} stripes {case.stripes}"
        code = make_code(*case.code)
        stripes = _ref_stripes(case)
        got = np.load(tmp_path / f"case{i}.npy")  # (S', alpha, sub), the collector's
        assert row["equal"] and row["others_zero"], label
        for s, stripe in enumerate(stripes):
            np.testing.assert_array_equal(got[s], stripe[case.failed], err_msg=label)
        # every rank's GF products ran (on the CPU here: the plain path)
        assert all(calls["ref"] > 0 and calls["cuda"] == 0 for calls in row["gf_calls"]), label
        assert row["counters"]["repair.bytes.host_staged"] == 0, label
        want = _ref_counters(case)
        assert {k: row["counters"][k] for k in want} == want, label
        cross = 0
        for s in range(len(stripes)):
            plan = code.repair_plan(case.failed, rotation=s)
            blocks = plan.traffic_blocks()["cross_rack_blocks"]
            cross += round(blocks * code.alpha) * case.sub
            if case.code[0] == "DRC":
                assert blocks == pytest.approx(drc_min_cross_rack_blocks(*case.code[1:])), label
        assert row["pod_sent_bytes"] == cross == row["counters"]["repair.bytes.cross_rack"], label
        if case.stripes:
            assert len(row["relayer_sets"]) > 1, row["relayer_sets"]
            continue
        out, spec = tcoll.spmd_repair(code, case.failed, torch.from_numpy(stripes[0]))
        assert row["collector_rank"] == spec.target_pod * spec.w
        np.testing.assert_array_equal(got[0], out[spec.target_pod * spec.w].numpy())


def test_every_sweep_shape_is_run():
    worlds = sorted({c[1] for c in CODES})
    run = [(c.code, c.failed) for world in worlds for c in _cases(world)]
    for c in CODES:
        assert (tuple(c), 0) in run and (tuple(c), c[1] - 1) in run


class FakeMesh:
    mesh_dim_names = ("pod", "node")

    def __init__(self, shape):
        self.shape = shape


def test_mesh_must_match_the_codes_rack_layout():
    code = make_code("DRC", 9, 6, 3)
    shard = torch.zeros((1, code.alpha, 64), dtype=torch.uint8)
    for shape in ((9, 1), (1, 9)):
        with pytest.raises(ValueError, match="do not match"):
            tcoll.spmd_repair(code, 0, shard, mesh=FakeMesh(shape))
    with pytest.raises(ValueError, match="do not match"):
        tcoll.spmd_node_recovery(code, 0, shard[None], mesh=FakeMesh((3, 3, 1)))


def test_make_repair_mesh_needs_a_process_group_of_r_times_w():
    from repro_torch.launch.mesh import make_repair_mesh

    with pytest.raises(RuntimeError, match="process group"):
        make_repair_mesh(3, 3, device_type="cpu")


def test_mesh_run_defaults_to_the_card():
    """The entry points run on the card unless the caller asks for the CPU."""
    import inspect

    for fn in (mesh_run.run, mesh_run.case_data):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
