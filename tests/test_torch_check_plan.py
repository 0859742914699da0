"""Port parity of the plan verifier: ``repro_torch.check.plan`` against the
reference's ``repro.check.plan``, record by record and finding by finding.

Both packages build the same codes and plans from the same specs, so every
``PlanRecord`` of the registry sweep (label, family, n/k/r, failed node,
status, each finding's rule, severity and witness, and ``info``) must be
equal; so must the mutation self-test's rows and the findings each mutated
plan draws.  The reference is called in process (never through its CLI).
"""
import numpy as np
import pytest

from repro.check import plan as rplan
from repro.core.codes import make_code as rmake_code

from repro_torch.check import plan as tplan
from repro_torch.check.report import FAIL
from repro_torch.core.codes import make_code as tmake_code

SWEEP = [(family, cfg) for family, shapes in rplan.REGISTRY_SWEEP.items() for cfg in shapes]


def _finding(f):
    d = f.as_dict()
    del d["message"]  # prose; the rule, severity and witness are the contract
    return d


def _record(rec):
    d = rec.as_dict()
    d["findings"] = [_finding(f) for f in rec.findings]
    return d


def test_catalog_is_the_reference_s():
    assert tplan.REGISTRY_SWEEP == rplan.REGISTRY_SWEEP
    assert list(tplan.PLAN_RULES) == list(rplan.PLAN_RULES)
    assert tplan.MUTATIONS == rplan.MUTATIONS


@pytest.mark.parametrize("family,cfg", SWEEP, ids=[f"{f}-{c[0]}{c[1:]}" for f, c in SWEEP])
def test_sweep_records_equal_the_reference_s(family, cfg):
    got = tplan.run_registry_sweep({family: [cfg]})
    want = rplan.run_registry_sweep({family: [cfg]})
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _record(g) == _record(w)
        assert g.status != FAIL


def test_whole_sweep_has_144_passing_records():
    report = tplan.sweep_report()
    assert len(report.plan_records) == 144
    assert report.ok and report.counts()["PASS"] == 144


def test_self_test_rows_equal_the_reference_s():
    rows = tplan.self_test()
    assert rows == rplan.self_test()
    assert all(caught for _, _, caught in rows)


@pytest.mark.parametrize("mutation", list(rplan.MUTATIONS))
def test_mutated_plan_findings_equal_the_reference_s(mutation):
    tcode, rcode = tmake_code("DRC", 6, 4, 3), rmake_code("DRC", 6, 4, 3)
    got = tplan.verify_plan(tcode, tplan.mutate_plan(tcode.repair_plan(0), mutation))
    want = rplan.verify_plan(rcode, rplan.mutate_plan(rcode.repair_plan(0), mutation))
    assert [_finding(f) for f in got] == [_finding(f) for f in want]
    owner = tplan.MUTATIONS[mutation]
    assert any(f.rule == owner and f.severity == FAIL for f in got)


@pytest.mark.parametrize("cfg", [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("DRC", 12, 9, 4)])
def test_every_mutation_is_caught_at_another_code(cfg):
    rows = tplan.self_test(cfg)
    assert rows == rplan.self_test(cfg)
    assert all(caught for _, _, caught in rows)


def test_construction_failure_is_a_finding():
    code = tmake_code("DRC", 6, 4, 3)
    recs = tplan.verify_code(code, failed_nodes=[code.n])  # no such node
    assert len(recs) == 1 and recs[0].status == FAIL
    assert recs[0].findings[0].rule == "plan.construction"


def test_witness_is_json_ready():
    code = tmake_code("DRC", 6, 4, 3)
    plan = tplan.mutate_plan(code.repair_plan(0), "zero_decode_row")
    rec = tplan.PlanRecord("x", "x", 6, 4, 3, 0, tplan.verify_plan(code, plan))
    d = rec.as_dict()
    assert d["status"] == FAIL
    assert all(not isinstance(v, np.generic) for f in d["findings"] for v in f["witness"].values())
