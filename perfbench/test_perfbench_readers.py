"""The reduction of a device trace and the metric readers, on made-up
readings whose answers are known."""
import math

import pytest

from perfbench import devtrace, harness, spec

BENCH = spec.load_benchmark()
PEAKS = {"hbm_bytes_per_s": 3.35e12}
DRC = spec.config(BENCH, "drc_9_6_3")


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    _event("perfbench.issue", "user_annotation", 1000.0, 300.0),
    _event("(anonymous namespace)::gf_bitsliced_kernel(unsigned char const*, int)", "kernel",
           1100.0, 200.0),
    _event("gf_bitsliced_kernel(unsigned char const*, int)", "kernel", 1300.0, 100.0),
    _event("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1350.0, 100.0),
    _event("perfbench.wait", "user_annotation", 1500.0, 400.0),
    _event("late", "kernel", 1900.0, 300.0),
    _event("perfbench.issue", "user_annotation", 2200.0, 100.0),
    _event("fill", "gpu_memset", 2300.0, 100.0),
]}


def test_reduce_busy_idle_names_and_gaps():
    d = devtrace.reduce(TRACE)
    assert math.isclose(d.window_s, 1300.0 * 1e-6)  # the first device start to the last end
    assert math.isclose(d.busy_s, (350.0 + 300.0 + 100.0) * 1e-6)
    assert math.isclose(d.device_s, 800.0 * 1e-6)
    assert math.isclose(d.seconds_matching("gf_"), 300.0 * 1e-6)
    assert set(d.by_name) == {"(anonymous namespace)::gf_bitsliced_kernel",
                              "gf_bitsliced_kernel", "Memcpy DtoD", "late", "fill"}
    assert d.gaps[0] == ("perfbench.wait", pytest.approx(450.0 * 1e-6))
    assert d.gaps[1] == ("perfbench.issue", pytest.approx(100.0 * 1e-6))
    assert len(d.gaps) == 2


def test_reduce_without_device_work_reads_nothing():
    host_only = [e for e in TRACE["traceEvents"] if e["cat"] == "user_annotation"]
    assert devtrace.reduce({"traceEvents": host_only}) is None
    assert devtrace.reduce({"traceEvents": []}) is None


def test_card_only_trace_names_gaps_host_idle():
    card = {"traceEvents": [e for e in TRACE["traceEvents"] if e["cat"] != "user_annotation"]}
    d = devtrace.reduce(card)
    assert math.isclose(d.busy_s / d.window_s, 750.0 / 1300.0)
    assert [name for name, _ in d.gaps] == ["host idle", "host idle"]


def test_a_family_reader_serves_every_cell_suffix():
    idle = [spec.metric_reader(f"device_idle_pct.{cell}") for cell in ("write", "recovery", "x")]
    assert {m.__file__ for m in idle} == {str(spec.HERE / "metrics" / "device_idle_pct.py")}
    exact = spec.metric_reader("gf_matmul_roofline.write")
    assert exact.__file__ == str(spec.HERE / "metrics" / "gf_matmul_roofline.write.py")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_family.write")


def _readings(**kw):
    base = dict(cfg=DRC, peaks=PEAKS, setup_s=9.5,
                credit_bytes=8 * 3 * DRC["sub_bytes"], blocks_per_op=8, stripes_per_op=8,
                window=harness.LoopStats(attempted=100, window_s=10.0, host_s=[0.016] * 100))
    base.update(kw)
    return harness.Readings(**base)


def test_end_to_end_readers():
    r = _readings()
    assert spec.metric_reader("setup_s").read(r) == 9.5
    assert spec.metric_reader("recovery_GBps").read(r) == pytest.approx(
        100 * 8 * 3 * DRC["sub_bytes"] / 10.0 / 1e9)
    lat = harness.LoopStats(attempted=100, latency_s=[i * 1e-3 for i in range(1, 101)])
    assert spec.metric_reader("degraded_read_p95_ms").read(_readings(window=lat)) == \
        pytest.approx(95.0)
    lat.latency_s[-6:] = [math.inf] * 6  # more than 5% failed: no p95
    assert spec.metric_reader("degraded_read_p95_ms").read(_readings(window=lat)) is None


def test_host_and_counter_readers():
    r = _readings(counters={"repair.bytes.cross_rack": 9 * 8 * 2 * 3 * DRC["sub_bytes"],
                            "kernel.gf_matmul.calls": 9 * 8 * 6}, counted_ops=9)
    assert spec.metric_reader("host_ms_per_stripe.recovery").read(r) == pytest.approx(2.0)
    assert spec.metric_reader("cross_rack_bytes_per_block.recovery").read(r) == 134_217_984
    assert spec.metric_reader("gf_calls_per_stripe.recovery").read(r) == 6
    assert spec.metric_reader("gf_calls_per_stripe.recovery").read(_readings()) is None


def test_roofline_and_idle_readers():
    d = devtrace.DeviceTrace(window_s=2.0, busy_s=1.5, device_s=1.6,
                             by_name={"gf_bitsliced_kernel": 1.2, "copy": 0.4}, gaps=[])
    traced = harness.LoopStats(attempted=100)
    r = _readings(device=d, traced=traced)
    least = 9 * 3 * DRC["sub_bytes"] / PEAKS["hbm_bytes_per_s"]  # 8 helpers read, 1 written
    assert spec.metric_reader("repair_roofline.recovery").read(r) == pytest.approx(
        100 * least / (1.6 / 800))
    w = _readings(device=d, traced=traced, stripes_per_op=1, blocks_per_op=0)
    assert spec.metric_reader("gf_matmul_roofline.write").read(w) == pytest.approx(
        100 * (27 * DRC["sub_bytes"] / PEAKS["hbm_bytes_per_s"]) / (1.2 / 100))
    assert spec.metric_reader("device_idle_pct.recovery").read(r) == pytest.approx(25.0)
    assert spec.metric_reader("repair_roofline.recovery").read(_readings(traced=traced)) is None
    assert spec.metric_reader("gf_matmul_roofline.write").read(
        _readings(device=d, traced=traced, peaks=None)) is None
