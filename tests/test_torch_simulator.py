"""Port parity: the §6 cluster simulator (``repro_torch.storage``) against the
JAX package's ``repro.storage``, over the cases of ``tests/test_simulator.py``.

The simulator is the same float arithmetic over the same plans in both
packages, so every value must be equal (``==``, no tolerance): the
``StageTimes`` of each plan, Table 3, and the Fig. 6-8 throughputs and
latencies, plus the traced stage spans and ``sim.*`` counters.
"""
import dataclasses

import pytest

from repro import obs as robs
from repro.core.codes import make_code as r_make_code
from repro.storage import ClusterSim as RClusterSim
from repro.storage import CostModel as RCostModel

from repro_torch import obs
from repro_torch.core.codes import make_code
from repro_torch.storage import ClusterSim, CostModel, StageTimes

rsim, sim = RClusterSim(), ClusterSim()
GBPS = (0.2, 0.5, 1.0, 2.0)
CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 5, 3), ("DRC", 6, 3, 3),
         ("MSR", 6, 3, 3), ("RS", 9, 6, 3), ("MSR", 9, 6, 3)]
IDS = lambda s: "%s%d%d%d" % s  # noqa: E731


def test_cost_model_equals_reference():
    assert dataclasses.asdict(CostModel()) == dataclasses.asdict(RCostModel())
    for g in GBPS:
        assert CostModel().gateway_mib_s(g) == RCostModel().gateway_mib_s(g)


@pytest.mark.parametrize("spec", CODES, ids=IDS)
def test_stage_times_equal_reference(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    for failed in range(ref.n):
        for block_mib, gbps in ((63.0, 1.0), (64.0, 2.0), (1.0, 0.2)):
            want = rsim.stage_times(ref, ref.repair_plan(failed), block_mib, gbps)
            got = sim.stage_times(port, port.repair_plan(failed), block_mib, gbps)
            assert isinstance(got, StageTimes)
            assert got.as_dict() == want.as_dict()
            assert list(got.as_dict()) == list(obs.STAGE_NAMES)
            assert (got.bottleneck, got.total, got.max_stage) == (
                want.bottleneck, want.total, want.max_stage)


@pytest.mark.parametrize("spec,block_mib", [(("DRC", 9, 6, 3), 63.0), (("DRC", 9, 5, 3), 64.0),
                                            (("RS", 9, 6, 3), 64.0), (("MSR", 9, 6, 3), 64.0)],
                         ids=lambda v: IDS(v) if isinstance(v, tuple) else str(v))
def test_table3_equals_reference(spec, block_mib):
    for g in GBPS:
        assert sim.table3_breakdown(make_code(*spec), block_mib, g) == \
            rsim.table3_breakdown(r_make_code(*spec), block_mib, g)


@pytest.mark.parametrize("gbps", GBPS)
def test_fig6_fig7_equal_reference(gbps):
    for spec in CODES:
        ref, port = r_make_code(*spec), make_code(*spec)
        assert sim.node_recovery_throughput(port, gateway_gbps=gbps) == \
            rsim.node_recovery_throughput(ref, gateway_gbps=gbps)
        assert sim.degraded_read_time(port, gateway_gbps=gbps) == \
            rsim.degraded_read_time(ref, gateway_gbps=gbps)
        assert sim.degraded_read_time(port, 63.0, gbps, failed=port.n - 1) == \
            rsim.degraded_read_time(ref, 63.0, gbps, failed=ref.n - 1)


def test_fig8_equals_reference():
    ref, port = r_make_code("DRC", 9, 5, 3), make_code("DRC", 9, 5, 3)
    for strip in (1, 8, 64, 256, 2048, 16384):
        assert sim.node_recovery_throughput(port, strip_kib=strip) == \
            rsim.node_recovery_throughput(ref, strip_kib=strip)
    for block in (1, 4, 16, 64, 256):
        assert sim.node_recovery_throughput(port, block_mib=block) == \
            rsim.node_recovery_throughput(ref, block_mib=block)


def test_traced_simulation_equals_reference():
    ref, port = r_make_code("DRC", 9, 6, 3), make_code("DRC", 9, 6, 3)
    with robs.tracing("ref") as rtr:
        rsim.node_recovery_throughput(ref, num_stripes=4)
        rsim.degraded_read_time(ref)
    with obs.tracing("port") as tr:
        sim.node_recovery_throughput(port, num_stripes=4)
        sim.degraded_read_time(port)

    def spans(t):
        return [(s.name, s.cat, s.dur_us, s.attrs) if s.cat == "stage" else (s.name, s.cat)
                for s in t.spans]

    assert spans(tr) == spans(rtr)
    # the port's metrics are the reference's, plus the plans it built
    got = tr.metrics.as_dict()
    assert set(got["counters"].pop("repair.plan.builds")) == {"family=DRC"}
    assert got == rtr.metrics.as_dict()
    stage = [s.name for s in tr.spans if s.cat == "stage"]
    assert stage[:7] == list(obs.STAGE_NAMES)
