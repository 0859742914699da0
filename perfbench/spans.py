"""The span stretch: the program's own ``repro_torch.obs`` spans and counters,
read together with the card's activity on one clock.

``stretch(fn, device)`` runs ``fn`` under ``obs.tracing`` and, if asked,
``torch.profiler``, and ``reduce`` turns the two into a `SpanStretch`: each
span name's count and host seconds, the counters, and every device-idle
interval's seconds split by the innermost program span open on the issuing
thread during it (``OUTSIDE`` for the harness's own time).  A profiler
trace's ``ts`` plus its ``baseTimeNanoseconds / 1000`` and
``obs.Tracer.unix_us`` of a span's start are both Unix-epoch microseconds,
and the profiler's host events agree with the spans; its device timestamps,
on an H100 host, drifted from them by up to 3 ms within 2 s.  So the
profiler records the host's operations too, and each idle interval is placed
on the host's clock: it ends at the host's call that launched the device
operation ending it.

The traced run (``harness.run_cell``) does not run this stretch; this module
runs it after a cell's set-up and an unprofiled part of its loop, once under
``obs`` alone and once with the profiler too:

    python3 perfbench/spans.py --workload drc_9_6_3.node_recovery --seed 7 --seconds 8

and prints one JSON line: the quantities of ``quantities`` under their names
with the cell's suffix (the host times from the part without the profiler,
which slows each launch on the host), the host ms a call of the three parts
(what ``obs`` and the profiler each cost), the idle seconds by span, each GF
launch's device start less its span's start, and the growth of the code's
plan cache's misses over the ``obs`` part.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import torch

OUTSIDE = "outside the program"
GF_KERNEL = "gf_bitsliced_kernel"
SPANS_S = 2.0
TOP = 10
SUFFIX = {"node_recovery": "recovery"}  # a traffic's suffix where it is not its name


@dataclasses.dataclass
class SpanStretch:
    spans: dict[str, list]  # span name -> [count, host seconds], the issuing thread's
    counters: dict[str, float]  # summed by name
    idle_s: float | None  # None: no device operation in the stretch
    window_s: float | None  # the first device operation's start to the last one's end
    idle_by_span: dict[str, float]  # idle seconds by the innermost open span
    idle_in_plan_s: float  # idle seconds while the thread was inside ``repair.plan``
    gf_offsets_us: list[float] | None  # GF kernel start less its span's start, in order
    gf_launches_in_span: float | None  # share of GF launch calls inside their spans
    start_less_call_us: list[float] | None  # each device start less its launch call's

    def host_s(self, name: str) -> float:
        return self.spans.get(name, [0, 0.0])[1]

    def count(self, name: str) -> int:
        return self.spans.get(name, [0, 0.0])[0]

    def top_idle(self, n: int = TOP) -> list[list]:
        ranked = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return [[name, s] for name, s in ranked]


def _innermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """Nested intervals ``(start, end, name)`` of one thread as consecutive
    segments, each named by the innermost interval open over it, or
    ``OUTSIDE``; the segments cover the whole line."""
    segs: list[tuple[float, float, str]] = []
    stack: list[tuple[float, float, str]] = []
    cur = -math.inf

    def emit(t: float) -> None:
        nonlocal cur
        if t > cur:
            segs.append((cur, t, stack[-1][2] if stack else OUTSIDE))
            cur = t

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][1] <= a:
            emit(stack[-1][1])
            stack.pop()
        emit(a)
        stack.append((a, b, name))
    while stack:
        emit(stack[-1][1])
        stack.pop()
    segs.append((cur, math.inf, OUTSIDE))
    return segs


def _split(idle: list[tuple[float, float]],
           segs: list[tuple[float, float, str]]) -> dict[str, float]:
    """Seconds of the ``idle`` intervals (µs) by the name of the segment
    over them."""
    starts = [s[0] for s in segs]
    out: dict[str, float] = {}
    for a, b in idle:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                out[segs[i][2]] = out.get(segs[i][2], 0.0) + (hi - lo) * 1e-6
            i += 1
    return out


def _overlap_s(xs: list[tuple[float, float]], ys: list[tuple[float, float]]) -> float:
    """Seconds of the intervals ``xs`` (µs) that lie in the sorted disjoint
    intervals ``ys``."""
    starts = [y[0] for y in ys]
    total = 0.0
    for a, b in xs:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(ys) and ys[i][0] < b:
            total += max(0.0, min(b, ys[i][1]) - max(a, ys[i][0]))
            i += 1
    return total * 1e-6


def reduce(trace: dict, tracer, thread: str) -> SpanStretch:
    """Reduce a profiler trace of the card and the tracer of the same stretch;
    ``thread`` is the track of the thread that issued the work."""
    from perfbench import devtrace

    unix_us = getattr(tracer, "unix_us", None)  # None: a program without the shared clock
    spans: dict[str, list] = {}
    timed: list[tuple[float, float, str]] = []
    for s in tracer.spans:
        if s.track != thread:
            continue
        agg = spans.setdefault(s.name, [0, 0.0])
        agg[0] += 1
        agg[1] += s.dur_us * 1e-6
        if unix_us is not None:
            a = unix_us(s.start_us)
            timed.append((a, a + s.dur_us, s.name))
    counters = {name: tracer.counter_value(name) for name, _ in tracer.metrics.counters}
    base_us = float(trace.get("baseTimeNanoseconds", 0)) / 1e3

    def interval(e: dict) -> tuple[float, float]:
        return float(e["ts"]) + base_us, float(e["ts"]) + float(e.get("dur", 0.0)) + base_us

    def corr(e: dict):
        return e.get("args", {}).get("correlation")

    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = [(*interval(e), e.get("name", "?"), corr(e)) for e in events
           if e.get("cat") in devtrace.DEVICE_CATS]
    if not dev:
        return SpanStretch(spans, counters, None, None, {}, 0.0, None, None, None)
    # the host's call that launched each device operation, by correlation id
    calls = {corr(e): interval(e) for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr(e) is not None}
    busy = devtrace._merge([(a, b) for a, b, _, _ in dev])
    opens = {}  # an operation that starts a busy interval, by its start
    for a, _, _, c in sorted(dev, key=lambda d: d[0]):
        opens.setdefault(a, c)
    # each idle interval on the host's clock: it ends at the call that launched
    # the operation ending it, where the host recorded that call (the card's
    # timestamps can drift from the host's by more than an idle gap lasts)
    idle = []
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        end = calls[opens[g1]][0] if opens[g1] in calls else g1
        idle.append((end - (g1 - g0), end))
    plan = devtrace._merge([(a, b) for a, b, name in timed if name == "repair.plan"])
    gf = [(a, c) for a, _, name, c in dev if GF_KERNEL in name]
    kernels = sorted(a for a, _ in gf)
    gf_calls = sorted(calls[c] for _, c in gf if c in calls)
    gf_spans = sorted((a, b) for a, b, name in timed if name == "kernel.gf_matmul")
    launches = [a for a, _ in gf_spans]
    return SpanStretch(
        spans=spans,
        counters=counters,
        idle_s=sum(b - a for a, b in idle) * 1e-6,
        window_s=(busy[-1][1] - busy[0][0]) * 1e-6,
        idle_by_span=_split(idle, _innermost(timed)) if unix_us is not None else {},
        idle_in_plan_s=_overlap_s(idle, plan),
        gf_offsets_us=([k - s for k, s in zip(kernels, launches)]
                       if launches and len(kernels) == len(launches) else None),
        gf_launches_in_span=(sum(s[0] <= c[0] and c[1] <= s[1]
                                 for c, s in zip(gf_calls, gf_spans)) / len(gf_calls)
                             if gf_calls and len(gf_calls) == len(gf_spans) else None),
        start_less_call_us=[a - calls[c][0] for a, _, _, c in dev if c in calls] or None,
    )


def stretch(fn: Callable[[], object], device: torch.device, *, profiled: bool = True):
    """(fn(), SpanStretch) with ``fn`` run under ``obs.tracing`` and, if
    ``profiled``, the profiler recording the card and the host's operations.
    The profiler slows the host, so the host times come from a stretch
    without it."""
    from repro_torch import obs
    from torch.profiler import profile

    from perfbench import devtrace
    from perfbench.drivers.common import sync

    thread = threading.current_thread().name
    sync(device)
    with obs.tracing("perfbench spans") as tr:
        if not profiled:
            out = fn()
            sync(device)
            return out, reduce({}, tr, thread)
        with profile(activities=devtrace._activities(device, host=True)) as prof:
            devtrace._marker(device)
            out = fn()
            devtrace._marker(device)
            sync(device)
    fd, path = tempfile.mkstemp(prefix="perfbench-spans-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    return out, reduce(trace, tr, thread)


def quantities(st: SpanStretch, ops: int, stripes_per_op: int) -> dict[str, float]:
    """The stretch's per-layer quantities, over its ``ops`` issued
    operations: each present where the program recorded what it reads."""
    out: dict[str, float] = {}
    stripes = ops * stripes_per_op
    if stripes and st.count("repair.plan"):
        out["plan_ms_per_stripe"] = st.host_s("repair.plan") * 1e3 / stripes
        out["launch_ms_per_stripe"] = st.host_s("repair.launch") * 1e3 / stripes
        # a stretch whose plans were all cached has no build to count
        out["plan_builds_per_stripe"] = st.counters.get("repair.plan.builds", 0.0) / stripes
    if st.count("kernel.gf_matmul"):
        out["gf_host_us_per_call"] = (st.host_s("kernel.gf_matmul") * 1e6
                                      / st.count("kernel.gf_matmul"))
    if st.idle_s and st.count("repair.plan"):
        out["device_idle_in_plan_pct"] = 100.0 * st.idle_in_plan_s / st.idle_s
    return out


def _mean_ms(values: list[float]) -> float | None:
    return sum(values) / len(values) * 1e3 if values else None


def run(workload: str, seed: int, seconds: float, *, device: str = "cuda",
        overrides: dict | None = None, root: Path | None = None) -> dict:
    """Set the cell up as a run does, run its loop with nothing on, then
    ``SPANS_S`` seconds (at most a quarter of ``seconds``) under ``obs``
    alone, which the host times come from, then as long under ``obs`` and
    the profiler, which the idle split and the launches' offsets come from."""
    from perfbench import devtrace, harness, spec, traffic
    from perfbench.drivers.common import sync

    root = spec.ROOT if root is None else root
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = dict(spec.config(bench, cell["config"], root))
    mix = dict(spec.mix(cell["traffic"]))
    cfg.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("mix", {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    drv = spec.driver(mix["entry"]).Driver(cfg, mix, seed, dev)
    distinct = traffic.all_ops(cfg, mix, seed)
    drv.warm(distinct)
    devtrace.warm(lambda: drv.issue(distinct[0]), dev)
    drv.arm()
    sync(dev)
    gc.collect()
    gc.freeze()
    stream = harness._Peek(traffic.schedule(cfg, mix, seed) if mix["loop"] == "open"
                           else traffic.ops(cfg, mix, seed))
    plan_cache = getattr(type(getattr(drv, "code", None)).__dict__.get("repair_plan"),
                         "cache_info", None)
    part = min(SPANS_S, seconds / 4)
    try:
        window = harness._loop(drv, mix, stream, seconds - 2 * part, dev)
        misses = plan_cache().misses if plan_cache else None
        timed, host = stretch(lambda: harness._loop(drv, mix, stream, part, dev), dev,
                              profiled=False)
        misses = plan_cache().misses - misses if plan_cache else None
        traced, st = stretch(lambda: harness._loop(drv, mix, stream, part, dev), dev)
        sync(dev)
    finally:
        gc.unfreeze()
    for name, stats in (("unprofiled", window), ("obs", timed), ("obs and profiler", traced)):
        print(f"perfbench: {name}: {harness.describe(stats)}", file=sys.stderr)
    drv.release()
    checks = drv.judge()
    suffix = SUFFIX.get(cell["traffic"], cell["traffic"])
    spo = drv.stripes_per_op
    found = quantities(host, len(timed.host_s), spo)
    found.pop("device_idle_in_plan_pct", None)
    profiled = quantities(st, len(traced.host_s), spo)
    if "device_idle_in_plan_pct" in profiled:
        found["device_idle_in_plan_pct"] = profiled.pop("device_idle_in_plan_pct")
    parts = {name: {"ops": len(stats.host_s), "window_s": stats.window_s,
                    "host_ms_per_call": _mean_ms(stats.host_s),
                    "failed": stats.failed + stats.never_done}
             for name, stats in (("unprofiled", window), ("obs", timed),
                                 ("obs_and_profiler", traced))}
    off, on, both = (parts[p]["host_ms_per_call"]
                     for p in ("unprofiled", "obs", "obs_and_profiler"))
    covered = found.get("plan_ms_per_stripe", 0.0) + found.get("launch_ms_per_stripe", 0.0)
    offsets = st.gf_offsets_us
    result = {
        "workload": workload, "seed": seed, "correct": all(c.ok for c in checks),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "parts": parts,
        "obs_cost_pct": 100.0 * (on / off - 1.0) if on and off else None,
        "profiler_cost_pct": 100.0 * (both / on - 1.0) if both and on else None,
        "metrics": {f"{name}.{suffix}": value for name, value in found.items()},
        "profiled_quantities": profiled,
        "spans_cover_pct": 100.0 * covered * spo / on if covered and on else None,
        "plan_builds": host.counters.get("repair.plan.builds"),
        "plan_cache_misses": misses,
        "device_idle_pct": (100.0 * st.idle_s / st.window_s
                            if st.idle_s is not None and st.window_s else None),
        "idle_by_span": st.top_idle(),
        "gf_launch_offset_us": None if not offsets else {
            "launches": len(offsets), "median": statistics.median(offsets),
            "min": min(offsets), "max": max(offsets)},
        "gf_launches_in_span": st.gf_launches_in_span,
        "start_less_call_us": None if not st.start_less_call_us else {
            "ops": len(st.start_less_call_us),
            "median": statistics.median(st.start_less_call_us),
            "min": min(st.start_less_call_us), "max": max(st.start_less_call_us)},
        "spans": host.spans,
        "counters": host.counters,
    }
    print("perfbench: idle s by span " + ", ".join(
        f"{name} {s:.6f}" for name, s in result["idle_by_span"]), file=sys.stderr)
    print(f"perfbench: host ms a call: nothing on {off}, obs {on}, obs and profiler {both}",
          file=sys.stderr)
    return result


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench: the span stretch needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench.run import card

    t = time.perf_counter()
    result = run(args.workload, args.seed, args.seconds)
    result["card"] = card()
    result["seconds_total"] = time.perf_counter() - t
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    _root = Path(__file__).resolve().parents[1]
    for _path in (_root / "src", _root):
        if str(_path) not in sys.path:
            sys.path.insert(0, str(_path))
    sys.exit(main())
