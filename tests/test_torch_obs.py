"""``repro_torch.obs`` on the Unix clock: a span's start read against the
host's clock, and an exported ``torch.profiler`` trace of the same stretch
lying on the span's timeline."""
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import obs


def test_span_unix_start_lies_between_time_ns_reads():
    with obs.tracing("clock") as tr:
        before = time.time_ns()
        with obs.span("s") as s:
            pass
        after = time.time_ns()
    start = tr.unix_us(s.start_us)
    assert before / 1e3 <= start <= after / 1e3
    assert start + s.dur_us <= after / 1e3 + 1.0  # 1 µs: the float's rounding
    (event,) = [e for e in obs.to_chrome_trace(tr)["traceEvents"] if e["ph"] == "X"]
    assert event["ts"] == start and event["dur"] == s.dur_us


def test_record_function_lands_inside_its_span_on_the_shared_clock(tmp_path):
    with obs.tracing("clock") as tr, profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with obs.span("outer") as outer:
            time.sleep(0.002)
            with record_function("inner"):
                torch.ones(64).sum()
            time.sleep(0.002)
        time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    (inner,) = [e for e in trace["traceEvents"]
                if e.get("ph") == "X" and e.get("name") == "inner"]
    start, end = inner["ts"] + base_us, inner["ts"] + inner["dur"] + base_us
    lo, hi = tr.unix_us(outer.start_us), tr.unix_us(outer.start_us + outer.dur_us)
    assert lo <= start <= end <= hi, (lo, start, end, hi)
