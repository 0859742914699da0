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
    _assert_plan_then_launch(tr, span)


def _assert_plan_then_launch(tr, root):
    """``repair.plan`` then ``repair.launch``, the root's only children, lie
    within it, and every span recorded descends from it."""
    by_id = {s.span_id: s for s in tr.spans}
    children = sorted((s for s in tr.spans if s.parent_id == root.span_id),
                      key=lambda s: s.start_us)
    assert [s.name for s in children] == ["repair.plan", "repair.launch"]
    plan, launch = children
    end = lambda s: s.start_us + s.dur_us  # noqa: E731
    assert root.start_us <= plan.start_us and end(plan) <= launch.start_us
    assert end(launch) <= end(root)
    for s in tr.spans:
        while s.parent_id is not None:
            s = by_id[s.parent_id]
        assert s is root
    assert {s.name for s in tr.spans if s.parent_id == launch.span_id} >= {
        "repair.inner", "repair.cross", "repair.decode"}


@pytest.mark.parametrize("spec", SPMD_CODES, ids=IDS)
def test_spmd_repair_spans_plan_and_launch(spec):
    port = make_code(*spec)
    stacked = torch.from_numpy(np.stack(_codeword(r_make_code(*spec), 64, 3)))
    with obs.tracing("spmd") as tr:
        tcoll.spmd_repair(port, 0, stacked)
    (root,) = tr.spans_named("repair.spmd")
    assert root.attrs["family"] == port.name and root.attrs["alpha"] == port.alpha
    _assert_plan_then_launch(tr, root)


@pytest.mark.parametrize("family", ["DRC", "RS"])
def test_plan_builds_count_the_plan_cache_misses(family):
    code = make_code(family, 9, 6, 3)  # a fresh code: nothing of it cached
    cached = getattr(type(code).repair_plan, "cache_info", None)
    payloads = torch.from_numpy(np.stack(
        [np.stack(_codeword(r_make_code(family, 9, 6, 3), 16, s)) for s in range(8)]))
    builds = []
    for _ in range(2):
        misses = cached().misses if cached else None
        with obs.tracing("recovery") as tr:
            tcoll.spmd_node_recovery(code, 4, payloads)
        builds.append(tr.counter_value("repair.plan.builds", family=code.name))
        assert tr.counter_value("repair.plan.builds") == builds[-1]
        if cached:
            assert cached().misses - misses == builds[-1]
    # DRC's plans are cached: the repeat builds none; RS builds every stripe's
    assert builds == ([8, 0] if family == "DRC" else [8, 8])


def test_untraced_execute_computes_no_counter(monkeypatch):
    code = make_code("DRC", 9, 6, 3)
    nodes = _codeword(r_make_code("DRC", 9, 6, 3), 32, 4)
    plan = code.repair_plan(0)
    helpers = {i: torch.from_numpy(nodes[i]) for i in plan.participants()}
    counted, schedules = [], []
    count_nonzero, record_schedule = np.count_nonzero, tcoll._record_schedule
    monkeypatch.setattr(np, "count_nonzero",
                        lambda *a, **k: counted.append(1) or count_nonzero(*a, **k))
    monkeypatch.setattr(tcoll, "_record_schedule",
                        lambda *a: schedules.append(1) or record_schedule(*a))
    body = tcoll.make_spmd_repair(tcoll.plan_to_spmd(code, plan))
    stacked = torch.from_numpy(np.stack(nodes))
    np.testing.assert_array_equal(plan.execute(helpers).numpy(), nodes[0])
    body(stacked)
    assert counted == [] and schedules == []
    with obs.tracing("traced"):  # the traced run books its counters
        plan.execute(helpers)
        body(stacked)
    assert counted and schedules == [1]


@pytest.mark.parametrize("spec", SPMD_CODES, ids=IDS)
def test_spmd_repair_into_garbage_out_zeroes_every_other_row(spec):
    port = make_code(*spec)
    sub = 96
    nodes = _codeword(r_make_code(*spec), sub, 5)
    stacked = torch.from_numpy(np.stack(nodes))
    for failed in (0, port.n - 1):
        sp = tcoll.plan_to_spmd(port, port.repair_plan(failed))
        out = torch.from_numpy(
            np.random.default_rng(failed).integers(1, 256, size=stacked.shape, dtype=np.uint8))
        got = tcoll.make_spmd_repair(sp)(stacked, out=out)
        assert got.data_ptr() == out.data_ptr()
        row = sp.target_pod * sp.w
        np.testing.assert_array_equal(out[row].numpy(), nodes[failed])
        assert not np.delete(out.numpy(), row, axis=0).any()


# NodeEncode rows per stripe by kind (computed / in place / skipped), and GF
# calls per stripe: the NodeEncode launch if any row is computed, one per
# place each relayer reads (its payload rows, the unit buffer), the decode
NODE_ENCODE_UNITS = {("DRC", 9, 6, 3): (4, 6, 17), ("RS", 9, 6, 3): (0, 6, 3),
                     ("DRC", 9, 5, 3): (0, 8, 10), ("MSR", 9, 6, 3): (0, 72, 9)}
GF_CALLS = {("DRC", 9, 6, 3): 6, ("RS", 9, 6, 3): 1, ("DRC", 9, 5, 3): 3, ("MSR", 9, 6, 3): 1}


@pytest.mark.parametrize("spec", SPMD_CODES, ids=IDS)
def test_node_encode_computes_only_the_coded_units(spec):
    port = make_code(*spec)
    sub = 40
    nodes = _codeword(r_make_code(*spec), sub, 6)
    stacked = torch.from_numpy(np.stack(nodes))
    rng = np.random.default_rng(7)
    for failed in range(port.n):
        for rotation in range(3):
            sp = tcoll.plan_to_spmd(port, port.repair_plan(failed, rotation))
            body = tcoll.make_spmd_repair(sp)
            out = torch.from_numpy(rng.integers(1, 256, size=stacked.shape, dtype=np.uint8))
            with obs.tracing("units") as tr:
                body(stacked, out=out)
            got = tuple(tr.counter_value("repair.node_encode.units", kind=kind)
                        for kind in ("computed", "in_place", "skipped"))
            assert got == NODE_ENCODE_UNITS[spec], (failed, rotation)
            assert tr.counter_value("kernel.gf_matmul.calls") == GF_CALLS[spec], (failed, rotation)
            row = sp.target_pod * sp.w
            np.testing.assert_array_equal(out[row].numpy(), nodes[failed])
            assert not np.delete(out.numpy(), row, axis=0).any()


@pytest.mark.parametrize("spec", [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3)], ids=IDS)
def test_spmd_ablation_variants_equal_the_shipped_executor(spec):
    from repro_torch.dist import spmd_ablation

    port = make_code(*spec)
    nodes = torch.from_numpy(np.stack(_codeword(r_make_code(*spec), 64, 9)))
    for failed in (0, port.n - 1):
        sp = tcoll.plan_to_spmd(port, port.repair_plan(failed))
        want = tcoll.make_spmd_repair(sp)(nodes)
        for name in spmd_ablation.VARIANTS:
            with spmd_ablation.variant(name):
                got = tcoll.make_spmd_repair(sp)(nodes, out=torch.full_like(nodes, 0xA5))
            assert torch.equal(got, want), name
    assert tcoll._relayer_encode is not spmd_ablation.relayer_encode_gather
    assert tcoll._classify_units is not spmd_ablation.classify_all_computed


def test_row_runs_and_take_rows():
    rows = [3, 4, 5, 27, 28, 9]
    runs = tcoll._row_runs(enumerate(rows))
    assert runs == [(0, 3, 3), (3, 27, 2), (5, 9, 1)]
    assert tcoll._row_runs([(0, 9), (2, 10), (3, 11)]) == [(0, 9, 1), (2, 10, 2)]
    src = torch.arange(40 * 3, dtype=torch.int32).reshape(40, 3)
    assert torch.equal(tcoll._take_rows(src, runs, len(rows)), src[rows])
    one = tcoll._row_runs(enumerate(range(9, 21)))
    assert one == [(0, 9, 12)]
    view = tcoll._take_rows(src, one, 12)
    assert view.data_ptr() == src[9].data_ptr() and torch.equal(view, src[9:21])
