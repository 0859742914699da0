"""The span stretch: the idle split and the quantities on a made-up profiler
trace and made-up spans whose answers are known, and a stretch of each mix
run on the CPU at a small size."""
import pytest

from perfbench import spans
from repro_torch import obs

EPOCH_NS = 1_000_000_000  # the tracer's epoch on the Unix clock: 1e6 µs
BASE_NS = 500_000_000  # the profiler trace's base: its ts is Unix µs less 5e5


def _tracer():
    tr = obs.Tracer("made up")
    tr.epoch_unix_ns = EPOCH_NS

    def span(sid, parent, name, a, b, track="MainThread"):
        tr.spans.append(obs.Span(sid, parent, name, "", track, a, b - a, {}))

    span(1, None, "repair.spmd_node_recovery", 100, 900)
    span(2, 1, "repair.plan", 110, 400)
    span(3, 1, "repair.launch", 400, 880)
    span(4, 3, "kernel.gf_matmul", 420, 440)
    span(5, 3, "kernel.gf_matmul", 600, 650)
    span(6, None, "another thread's", 0, 1000, track="worker")
    tr.counter_add("repair.plan.builds", 2, family="DRC")
    tr.counter_add("repair.plan.builds", 1, family="RS")
    return tr


def _device(name, cat, a, b):
    """A device event from Unix µs (less the tracer's epoch)."""
    ts = EPOCH_NS / 1e3 + a - BASE_NS / 1e3
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": b - a}


def _tied(event, correlation):
    return {**event, "args": {"correlation": correlation}}


TRACE = {"baseTimeNanoseconds": BASE_NS, "traceEvents": [
    _device("fill", "gpu_memset", 50, 60),
    _tied(_device("(anonymous namespace)::gf_bitsliced_kernel(unsigned char const*)",
                  "kernel", 450, 550), 7),
    _tied(_device("gf_bitsliced_kernel", "kernel", 660, 700), 9),
    _tied(_device("fill", "kernel", 950, 960), 8),
    {"ph": "X", "name": "a host op", "cat": "cpu_op", "ts": 0.0, "dur": 1e9},
    # the launch calls: the first inside its span (420-440), the second not (600-650)
    _tied(_device("cudaLaunchKernel", "cuda_runtime", 425, 435), 7),
    _tied(_device("cudaLaunchKernel", "cuda_runtime", 640, 655), 9),
    _tied(_device("cudaLaunchKernel", "cuda_runtime", 945, 948), 8),  # the fill's
]}


CARD_ONLY = {**TRACE, "traceEvents": [e for e in TRACE["traceEvents"]
                                      if e["cat"] != "cuda_runtime"]}


@pytest.mark.parametrize("trace,want,plan_s", [
    # each idle interval ends at the launch call of the operation ending it:
    # 35-425, 530-640 and 695-945 on the host's clock
    (TRACE, {spans.OUTSIDE: 110e-6, "repair.spmd_node_recovery": 30e-6,
             "repair.plan": 290e-6, "repair.launch": 275e-6, "kernel.gf_matmul": 45e-6},
     290e-6),
    # without the launch calls, on the card's clock: 60-450, 550-660, 700-950
    (CARD_ONLY, {spans.OUTSIDE: 90e-6, "repair.spmd_node_recovery": 30e-6,
                 "repair.plan": 290e-6, "repair.launch": 270e-6, "kernel.gf_matmul": 70e-6},
     290e-6),
], ids=["launch calls", "card only"])
def test_idle_split_by_the_innermost_span_of_the_issuing_thread(trace, want, plan_s):
    st = spans.reduce(trace, _tracer(), "MainThread")
    assert st.window_s == pytest.approx(910e-6)
    assert st.idle_s == pytest.approx(750e-6)
    assert st.idle_by_span == pytest.approx(want)
    assert sum(st.idle_by_span.values()) == pytest.approx(st.idle_s)
    assert st.top_idle(1) == [["repair.plan", pytest.approx(290e-6)]]
    assert st.idle_in_plan_s == pytest.approx(plan_s)
    assert st.gf_offsets_us == pytest.approx([30.0, 60.0])
    assert st.spans["kernel.gf_matmul"] == [2, pytest.approx(70e-6)]
    assert "another thread's" not in st.spans
    assert st.counters == {"repair.plan.builds": 3}


def test_launch_calls_against_spans_and_device_starts():
    st = spans.reduce(TRACE, _tracer(), "MainThread")
    assert st.gf_launches_in_span == 0.5  # the second call ends after its span
    assert st.start_less_call_us == pytest.approx([25.0, 20.0, 5.0])
    card = spans.reduce(CARD_ONLY, _tracer(), "MainThread")
    assert card.gf_launches_in_span is None and card.start_less_call_us is None


def test_quantities_read_the_spans_and_the_counter():
    st = spans.reduce(TRACE, _tracer(), "MainThread")
    q = spans.quantities(st, ops=1, stripes_per_op=8)
    assert q == pytest.approx({
        "plan_ms_per_stripe": 0.290 / 8, "launch_ms_per_stripe": 0.480 / 8,
        "plan_builds_per_stripe": 3 / 8, "gf_host_us_per_call": 35.0,
        "device_idle_in_plan_pct": 100 * 290 / 750})
    assert spans.quantities(st, ops=0, stripes_per_op=8) == {
        "gf_host_us_per_call": pytest.approx(35.0),
        "device_idle_in_plan_pct": pytest.approx(100 * 290 / 750)}


def test_a_stretch_without_device_work_reads_spans_alone():
    host = {"traceEvents": [e for e in TRACE["traceEvents"] if e["cat"] == "cpu_op"]}
    st = spans.reduce(host, _tracer(), "MainThread")
    assert st.idle_s is None and st.idle_by_span == {} and st.gf_offsets_us is None
    assert st.gf_launches_in_span is None and st.start_less_call_us is None
    assert spans.quantities(st, ops=1, stripes_per_op=8)["plan_builds_per_stripe"] == 3 / 8
    assert "device_idle_in_plan_pct" not in spans.quantities(st, ops=1, stripes_per_op=8)
    st.counters.clear()  # every plan cached: none built
    assert spans.quantities(st, ops=1, stripes_per_op=8)["plan_builds_per_stripe"] == 0.0


def test_unmatched_launches_give_no_offsets():
    trace = {**TRACE, "traceEvents": TRACE["traceEvents"][:2]}
    st = spans.reduce(trace, _tracer(), "MainThread")
    assert st.gf_offsets_us is None and st.gf_launches_in_span is None


class _NoClock:
    """A tracer of a program without the shared clock: spans, no Unix time."""

    def __init__(self, tracer):
        self.spans, self.metrics = tracer.spans, tracer.metrics
        self.counter_value = tracer.counter_value


def test_a_program_without_the_shared_clock_reads_no_split():
    st = spans.reduce(TRACE, _NoClock(_tracer()), "MainThread")
    assert st.idle_s == pytest.approx(750e-6) and st.spans["repair.plan"][0] == 1
    assert st.idle_by_span == {} and st.idle_in_plan_s == 0 and st.gf_offsets_us is None
    assert st.gf_launches_in_span is None


@pytest.mark.parametrize("cell,names", [
    ("drc_9_6_3.node_recovery", {"plan_ms_per_stripe.recovery", "launch_ms_per_stripe.recovery",
                                 "plan_builds_per_stripe.recovery",
                                 "gf_host_us_per_call.recovery"}),
    ("rs_9_6_3.node_recovery", {"plan_ms_per_stripe.recovery", "launch_ms_per_stripe.recovery",
                                "plan_builds_per_stripe.recovery",
                                "gf_host_us_per_call.recovery"}),
    ("drc_9_6_3.degraded_read", {"gf_host_us_per_call.degraded_read"}),
    ("drc_9_6_3.write", {"gf_host_us_per_call.write"}),
])
def test_a_stretch_on_the_cpu(cell, names, small):
    got = spans.run(cell, 2718281828, 0.8, device="cpu", overrides=small)
    assert got["correct"]
    for part in got["parts"].values():
        assert part["ops"] > 0 and part["failed"] == 0
    assert set(got["metrics"]) == names
    assert got["device_idle_pct"] is None and got["idle_by_span"] == []  # no card
    if "plan_builds_per_stripe.recovery" in names:
        # the spans lie within the calls the harness times
        assert 0 < got["spans_cover_pct"] <= 100
        assert got["spans"]["repair.plan"][0] == got["parts"]["obs"]["ops"]
    if cell.startswith("rs_"):
        assert got["metrics"]["plan_builds_per_stripe.recovery"] == 1.0
    if cell == "drc_9_6_3.node_recovery":
        assert (got["plan_builds"] or 0) == got["plan_cache_misses"]
