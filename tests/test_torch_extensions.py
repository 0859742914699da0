"""Port parity: the §7 extensions — multi-failure repair, lazy repair and
code switching (``repro_torch.core.multi_failure``) against the JAX package's
``repro.core.multi_failure``, after ``tests/test_extensions.py``.

The same numpy codewords go through both packages; reconstructions and
re-encoded payloads must be byte-equal, reports and action streams equal.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core.codes import make_code as r_make_code
from repro.core.multi_failure import CodeSwitcher as RCodeSwitcher
from repro.core.multi_failure import LazyRepairPolicy as RLazyRepairPolicy
from repro.core.multi_failure import multi_failure_repair as r_multi_failure_repair

from repro_torch import obs
from repro_torch.core.codes import make_code
from repro_torch.core.multi_failure import (
    CodeSwitcher,
    LazyRepairPolicy,
    MultiRepairReport,
    multi_failure_repair,
)

CODES = [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3), ("MSR", 6, 3, 3)]
IDS = lambda s: "%s%d%d%d" % s  # noqa: E731


def _stripe(code, seed=0, sub=32):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(code.k * code.alpha, sub), dtype=np.uint8)
    return dict(enumerate(code.encode(data)))


def _failure_sets(n, k, seed):
    """Every failure count from 2 to n-k: a few seeded sets each, plus the
    first and last nodes together."""
    rng = np.random.default_rng(seed)
    sets = [[0, n - 1]]
    for nfail in range(2, n - k + 1):
        for _ in range(3):
            sets.append(sorted(rng.choice(n, size=nfail, replace=False).tolist()))
    return sets


@pytest.mark.parametrize("spec", CODES, ids=IDS)
def test_multi_failure_repair_equals_reference(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    payloads = _stripe(ref, seed=sum(spec[1:]))
    for failed in _failure_sets(ref.n, ref.k, seed=ref.n * ref.k):
        avail = {i: p for i, p in payloads.items() if i not in failed}
        want, rrep = r_multi_failure_repair(ref, failed, avail)
        with obs.tracing("multi") as tr:
            got, rep = multi_failure_repair(
                port, failed, {i: torch.from_numpy(p) for i, p in avail.items()})
        assert list(got) == list(want) == failed
        for f in failed:
            np.testing.assert_array_equal(got[f].numpy(), want[f])
            np.testing.assert_array_equal(got[f].numpy(), payloads[f])
        assert isinstance(rep, MultiRepairReport)
        assert (rep.failed, rep.helpers, rep.cross_rack_blocks, rep.inner_rack_blocks) == (
            rrep.failed, rrep.helpers, rrep.cross_rack_blocks, rrep.inner_rack_blocks)
        assert rep.cross_rack_blocks + rep.inner_rack_blocks == port.k
        # one decode and one re-encode of the failed rows, through the GF entry point
        assert tr.counter_value("kernel.gf_matmul.calls") == 2


@pytest.mark.parametrize("spec", CODES, ids=IDS)
def test_multi_failure_single_uses_layered_plan(spec):
    ref, port = r_make_code(*spec), make_code(*spec)
    payloads = _stripe(ref, seed=3)
    for f in (0, ref.n - 1):
        avail = {i: p for i, p in payloads.items() if i != f}
        want, rrep = r_multi_failure_repair(ref, [f], avail)
        with obs.tracing("single") as tr:
            got, rep = multi_failure_repair(
                port, [f], {i: torch.from_numpy(p) for i, p in avail.items()})
        np.testing.assert_array_equal(got[f].numpy(), want[f])
        assert rep.helpers == rrep.helpers == port.repair_plan(f).participants()
        assert rep.cross_rack_blocks == rrep.cross_rack_blocks
        assert rep.inner_rack_blocks == rrep.inner_rack_blocks
        assert tr.spans_named("repair.execute")  # the layered plan ran
    if spec[0] == "DRC":
        assert rep.cross_rack_blocks == pytest.approx(
            port.theoretical_cross_rack_blocks())  # Eq. (3)


def test_multi_failure_edges():
    port = make_code("DRC", 9, 6, 3)
    payloads = {i: torch.from_numpy(p) for i, p in _stripe(r_make_code("DRC", 9, 6, 3)).items()}
    with pytest.raises(ValueError, match="exceed"):
        multi_failure_repair(port, [0, 1, 2, 3], payloads)
    out, rep = multi_failure_repair(port, [], payloads)
    assert out == {} and rep == MultiRepairReport([], [], 0.0, 0.0)


def test_lazy_repair_policy_action_stream_equals_reference():
    for spec, threshold in itertools.product(
            [("DRC", 9, 6, 3), ("DRC", 9, 5, 3), ("RS", 9, 6, 3)], (1, 2, 3)):
        ref, port = RLazyRepairPolicy(spec, threshold), LazyRepairPolicy(spec, threshold)
        rng = np.random.default_rng(threshold)
        for step in range(40):
            node = int(rng.integers(0, spec[1]))
            op = step % 4
            if op == 3:
                nodes = sorted(ref.failed)[:2]
                ref.repaired(nodes)
                port.repaired(nodes)
            elif op == 2:
                assert port.on_degraded_read(node) == ref.on_degraded_read(node)
            else:
                assert port.on_failure(node) == ref.on_failure(node)
            assert port.failed == ref.failed
            assert port.batched_saving_blocks() == ref.batched_saving_blocks()


def test_lazy_repair_policy():
    pol = LazyRepairPolicy(threshold=2)
    assert pol.on_failure(0) == "defer"
    assert pol.on_degraded_read(0) == "repair_single"
    assert pol.on_degraded_read(5) == "direct"
    assert pol.on_failure(1) == "repair_batch"
    assert pol.on_failure(2) == "repair_now"  # n-k edge
    assert pol.batched_saving_blocks() > 0  # batching beats eager
    pol.repaired([0, 1, 2])
    assert pol.on_failure(7) == "defer"


@pytest.mark.parametrize("width", [64, 61])  # 61: RS(8,6,4) takes it, DRC pads
def test_code_switcher_equals_reference(width):
    ref, port = RCodeSwitcher(), CodeSwitcher()
    blocks = np.random.default_rng(width).integers(0, 256, size=(6, width), dtype=np.uint8)
    for accesses in (0, 3, 20, 0):  # cold, still cold, hot, hot
        for _ in range(accesses):
            ref.record_access(1)
            port.record_access(1)
        assert port.target_code(1) == ref.target_code(1)
        assert port.plan_switches() == ref.plan_switches()
        want = ref.switch(1, blocks)
        got = port.switch(1, torch.from_numpy(blocks))
        assert port.placement == ref.placement
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        code = make_code(*port.target_code(1))
        data = code.decode({i: got[i] for i in range(code.k)})
        np.testing.assert_array_equal(data.reshape(6, -1)[:, :width].numpy(), blocks)
    hot, cold = make_code(*port.hot_spec), make_code(*port.cold_spec)
    assert hot.repair_plan(0).traffic_blocks()["cross_rack_blocks"] < \
        cold.repair_plan(0).traffic_blocks()["cross_rack_blocks"]
