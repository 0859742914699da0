"""Port parity: layered repair — ``RepairPlan.execute`` and the emulated-mesh
SPMD executor — against the JAX package.

Same codewords through both packages; reconstructions, ``plan_to_spmd``
specs and the traced ``repair.*`` counters must be equal.  The reference's
SPMD executor needs a 9-device host mesh (tests/test_dist.py runs it in a
subprocess); its output row ``target_pod * w`` is the failed payload, which
is what the port's output is held to here.
"""
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core.codes import make_code as r_make_code
from repro.dist import collectives as rcoll

from repro_torch import obs
from repro_torch.core.codes import make_code
from repro_torch.dist import collectives as tcoll

SPMD_CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3)]
PLAN_SHAPES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 5, 3), ("MSR", 6, 3, 3)]
IDS = lambda s: "%s%d%d%d" % s  # noqa: E731


def _codeword(code, sub, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(code.k * code.alpha, sub), dtype=np.uint8)
    return code.encode(data)


def _counters(tracer, scopes=("inner", "cross")):
    return {s: tracer.counter_value(f"repair.bytes.{s}_rack") for s in scopes}


@pytest.mark.parametrize("spec", PLAN_SHAPES, ids=IDS)
def test_execute_matches_reference_with_equal_counters(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    sub = 128
    nodes = _codeword(ref, sub, 1)
    for failed in (0, ref.n - 1):
        rplan, tplan = ref.repair_plan(failed), port.repair_plan(failed)
        helpers = rplan.participants()
        with robs.tracing("ref") as rtr:
            want = rplan.execute({i: nodes[i] for i in helpers})
        with obs.tracing("port") as tr:
            got = tplan.execute({i: torch.from_numpy(nodes[i]) for i in helpers})
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, nodes[failed])
        assert _counters(tr) == _counters(rtr)
        blocks = tplan.traffic_blocks()
        for scope in ("inner", "cross"):
            assert _counters(tr)[scope] == pytest.approx(
                blocks[f"{scope}_rack_blocks"] * port.alpha * sub)
        for relayer in tplan.relayers:
            assert tr.counter_value("repair.units_cross", relayer=str(relayer)) == \
                rtr.counter_value("repair.units_cross", relayer=str(relayer))
        assert tr.counter_value("repair.gf_mult_bytes") == \
            rtr.counter_value("repair.gf_mult_bytes")
        names = {s.name for s in tr.spans}
        assert {"repair.execute", "repair.node_encode", "repair.decode"} <= names


def _spec_fields(spec):
    return {f: getattr(spec, f) for f in spec.__dataclass_fields__}


@pytest.mark.parametrize("spec", SPMD_CODES, ids=IDS)
def test_plan_to_spmd_matches_reference(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    for failed in range(ref.n):
        for rotation in (0, 1):
            want = _spec_fields(rcoll.plan_to_spmd(ref, ref.repair_plan(failed, rotation)))
            got = _spec_fields(tcoll.plan_to_spmd(port, port.repair_plan(failed, rotation)))
            assert got.keys() == want.keys()
            for key, value in want.items():
                if isinstance(value, np.ndarray):
                    np.testing.assert_array_equal(got[key], value, err_msg=key)
                    assert got[key].dtype == value.dtype, key
                else:
                    assert got[key] == value, key


@pytest.mark.parametrize("spec", SPMD_CODES, ids=IDS)
def test_spmd_repair_reconstructs_target_row(spec):
    port = make_code(*spec)
    sub = 128
    nodes = _codeword(r_make_code(*spec), sub, 0)
    stacked = torch.from_numpy(np.stack(nodes))
    for failed in (0, port.n - 1):
        with obs.tracing("spmd") as tr:
            out, sp = tcoll.spmd_repair(port, failed, stacked)
        out = out.numpy()
        row = sp.target_pod * sp.w
        np.testing.assert_array_equal(out[row], nodes[failed])
        others = np.delete(out, row, axis=0)
        assert not others.any()
        blocks = port.repair_plan(failed).traffic_blocks()
        assert _counters(tr) == {
            s: round(blocks[f"{s}_rack_blocks"] * port.alpha) * sub for s in ("inner", "cross")
        }
        assert tcoll.cross_units_scheduled(sp) == tcoll.expected_cross_units(
            port.repair_plan(failed))
        assert {"repair.spmd", "repair.inner", "repair.cross", "repair.decode"} <= {
            s.name for s in tr.spans}


def test_spmd_node_recovery_rotates_relayers():
    code = make_code("DRC", 9, 6, 3)
    ref = r_make_code("DRC", 9, 6, 3)
    stripes = [_codeword(ref, 64, s) for s in range(4)]
    payloads = torch.from_numpy(np.stack([np.stack(ps) for ps in stripes]))
    dead = 0
    with obs.tracing("recovery") as tr:
        out, specs = tcoll.spmd_node_recovery(code, dead, payloads)
    for s, sp in enumerate(specs):
        np.testing.assert_array_equal(out[s, sp.target_pod * sp.w].numpy(), stripes[s][dead])
        want = rcoll.plan_to_spmd(ref, ref.repair_plan(dead, rotation=s))
        np.testing.assert_array_equal(sp.rel_idx, want.rel_idx)
    rel_sets = {tuple(sp.rel_idx.tolist()) for sp in specs}
    assert len(rel_sets) > 1, rel_sets
    (span,) = tr.spans_named("repair.spmd_node_recovery")
    assert span.attrs["distinct_relayer_sets"] == len(rel_sets)
    assert tr.counter_value("repair.bytes.cross_rack") == sum(
        sp.traffic_bytes(64)["cross_rack"] for sp in specs)
