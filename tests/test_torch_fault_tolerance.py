"""Port parity: the fault-tolerance control plane
(``repro_torch.train.fault_tolerance``) against the JAX package's
``repro.train.fault_tolerance``.

The same heartbeats, step times and fake clock give the same failed nodes,
stragglers, relayer orders and recovery actions in both packages;
``execute`` and ``rescale`` restore the state bit for bit (their payloads are
byte-equal to the reference's); under ``obs.tracing`` the ``ft.*`` span
names and counter values are equal.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.train import checkpoint as rck
from repro.train import fault_tolerance as rft

from repro_torch import obs
from repro_torch.train import checkpoint as tck
from repro_torch.train.fault_tolerance import (
    FailureDetector,
    FaultToleranceManager,
    RecoveryAction,
    StragglerMonitor,
)


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((37, 53)).astype(np.float32),
        "b": np.arange(11, dtype=np.int32),
        "nested": {"m": rng.standard_normal((5, 7)).astype(ml_dtypes.bfloat16)},
    }


def _jax_state(arrays):
    return {k: _jax_state(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in arrays.items()}


def _torch_state(arrays):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return {k: _torch_state(v) if isinstance(v, dict) else leaf(v) for k, v in arrays.items()}


def _assert_state_equal(got, arrays):
    assert got.keys() == arrays.keys()
    for key, want in arrays.items():
        if isinstance(want, dict):
            _assert_state_equal(got[key], want)
        else:
            np.testing.assert_array_equal(
                got[key].contiguous().reshape(-1).view(torch.uint8).numpy(),
                want.reshape(-1).view(np.uint8))


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_failure_detector_equals_reference():
    rclock, clock = FakeClock(100.0), FakeClock(100.0)
    ref, port = rft.FailureDetector(timeout_s=10, clock=rclock), FailureDetector(
        timeout_s=10, clock=clock)
    rng = np.random.default_rng(0)
    with robs.tracing("ref") as rtr, obs.tracing("port") as tr:
        for step in range(60):
            dt = float(rng.uniform(0.0, 4.0))
            rclock.t += dt
            clock.t += dt
            node = int(rng.integers(0, 9))
            if step % 7 == 3:  # an explicit timestamp, as the reference test gives
                ref.heartbeat(node, now=rclock.t - 5.0)
                port.heartbeat(node, now=clock.t - 5.0)
            elif node % 3:  # nodes 0, 3, 6 stop beating
                ref.heartbeat(node)
                port.heartbeat(node)
            assert port.failed_nodes() == ref.failed_nodes()
            assert port.failed_nodes(now=clock.t + 7.0) == ref.failed_nodes(now=rclock.t + 7.0)
    assert port.last_beat == ref.last_beat
    assert tr.metrics.as_dict() == rtr.metrics.as_dict()


def test_straggler_monitor_equals_reference():
    ref, port = rft.StragglerMonitor(threshold=1.5, window=8), StragglerMonitor(
        threshold=1.5, window=8)
    rng = np.random.default_rng(1)
    with robs.tracing("ref") as rtr, obs.tracing("port") as tr:
        for step in range(80):
            pod = int(rng.integers(0, 4))
            t = float(rng.uniform(0.9, 1.1)) * (2.0 if pod == 2 and step > 30 else 1.0)
            ref.report(pod, t, now=float(step))
            port.report(pod, t, now=float(step))
            assert port.stragglers() == ref.stragglers()
            assert port.preferred_relayer_order([3, 2, 1, 0]) == \
                ref.preferred_relayer_order([3, 2, 1, 0])
    assert port.stragglers() == [2]
    assert port.times == ref.times and port.last_seen == ref.last_seen
    assert tr.metrics.as_dict() == rtr.metrics.as_dict()


def test_plan_recovery_equals_reference():
    arrays = _arrays(0)
    rck_ = rck.encode_state(_jax_state(arrays), n=9, k=6, r=3)
    tck_ = tck.encode_state(_torch_state(arrays), n=9, k=6, r=3, device="cpu")
    rmgr, mgr = rft.FaultToleranceManager(), FaultToleranceManager(clock=FakeClock())
    for lost in ([], [4], [0], [1, 2], [0, 5, 8], [1, 2, 3, 4], list(range(9))):
        want, got = rmgr.plan_recovery(rck_, lost), mgr.plan_recovery(tck_, lost)
        assert isinstance(got, RecoveryAction)
        assert (got.kind, got.detail) == (want.kind, want.detail)


@pytest.mark.parametrize("lost", [[], [4], [0], [1, 2], [0, 5, 8]])
def test_execute_restores_state_with_equal_spans_and_counters(lost):
    arrays = _arrays(1)
    jstate, tstate = _jax_state(arrays), _torch_state(arrays)
    rckpt = rck.encode_state(jstate, n=9, k=6, r=3)
    tckpt = tck.encode_state(tstate, n=9, k=6, r=3, device="cpu")
    with robs.tracing("ref") as rtr:
        _, rreport, raction = rft.FaultToleranceManager().execute(rckpt, jstate, lost)
    with obs.tracing("port") as tr:
        got, report, action = FaultToleranceManager(clock=FakeClock()).execute(
            tckpt, tstate, lost)
    _assert_state_equal(got, arrays)
    assert (action.kind, action.detail) == (raction.kind, raction.detail)
    assert (report.mode, report.repaired_nodes, report.cross_rack_blocks) == (
        rreport.mode, rreport.repaired_nodes, rreport.cross_rack_blocks)
    assert [s.name for s in tr.spans if s.name.startswith(("ft.", "ckpt."))] == \
        [s.name for s in rtr.spans if s.name.startswith(("ft.", "ckpt."))]
    for name in ("ft.recoveries", "ckpt.restores", "repair.bytes.cross_rack",
                 "repair.bytes.inner_rack"):
        assert tr.counter_value(name) == rtr.counter_value(name), name
    (span,) = tr.spans_named("ft.execute")
    (rspan,) = rtr.spans_named("ft.execute")
    assert span.attrs == rspan.attrs


def test_execute_refuses_past_n_minus_k():
    arrays = _arrays(2)
    tstate = _torch_state(arrays)
    ckpt = tck.encode_state(tstate, n=9, k=6, r=3, device="cpu")
    with obs.tracing("port") as tr:
        with pytest.raises(RuntimeError, match="roll back"):
            FaultToleranceManager().execute(ckpt, tstate, [0, 1, 2, 3])
    assert tr.counter_value("ft.recoveries") == 0
    assert [s.name for s in tr.spans] == ["ft.plan_recovery", "ft.execute"]


@pytest.mark.parametrize("new", [(6, 4, 3), (9, 5, 3), (8, 6, 4)])
def test_rescale_equals_reference(new):
    arrays = _arrays(3)
    jstate, tstate = _jax_state(arrays), _torch_state(arrays)
    rckpt = rck.encode_state(jstate, family="DRC", n=9, k=6, r=3, step=5)
    tckpt = tck.encode_state(tstate, family="DRC", n=9, k=6, r=3, step=5, device="cpu")
    n, k, r = new
    with robs.tracing("ref") as rtr:
        want = rft.FaultToleranceManager().rescale(rckpt, jstate, n=n, k=k, r=r)
    with obs.tracing("port") as tr:
        got = FaultToleranceManager().rescale(tckpt, tstate, n=n, k=k, r=r)
    assert got.code_spec == want.code_spec == ("DRC", n, k, r)
    assert got.step == want.step == 5
    for i in range(n):
        np.testing.assert_array_equal(got.payloads[i].numpy(), want.payloads[i])
    (span,) = tr.spans_named("ft.rescale")
    (rspan,) = rtr.spans_named("ft.rescale")
    assert span.attrs == rspan.attrs
    restored, report = tck.restore_state(got, tstate, available=set(range(n)) - {1})
    assert report.mode == "repair"
    _assert_state_equal(restored, arrays)
