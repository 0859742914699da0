"""Run one cell: set-up, warm-up, the measured window, the comparison with the
reference, and the metrics its readers take from what the run recorded.

Two loops serve every mix:

* ``closed``: operations issued back to back, at most ``inflight`` of them
  enqueued on the card; the window closes after ``--seconds`` once all
  issued work has finished, and a rate is the work done over that time;
* ``open``: operations issued at their due times (``traffic.schedule``)
  whatever the card's backlog; each is timed from its due time until the
  host sees its completion event, recorded after its last launch, passed
  on the card: the loop polls the events of the reads in flight after each
  issue and while it waits for the next due time, and once the window has
  closed, so a read that completes while the host issues another is seen
  when that issue returns.  A read that failed counts as infinite, and a
  stall counts against every read that waited behind it.

A traced run (``--trace 1``) first counts the program's ``repro_torch.obs``
counters over one pass of every distinct operation, then runs the window in
three parts, all with ``obs`` off: the first with nothing on (host times,
generator lag), then ``PROFILED_S`` seconds under ``torch.profiler``
recording the card alone (device times), then ``GAPS_S`` seconds recording
the host too, which only names the idle gaps of the breakdown.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import time
import traceback
from pathlib import Path

import torch

from . import devtrace, spec, traffic
from .checks import Check
from .drivers.common import sync as _sync

PROFILED_S = 2.0  # the stretch the device metrics read, the card's activity alone
GAPS_S = 0.5  # the stretch that names the idle gaps, the host's operations recorded too
DONE_GRACE_S = 60.0  # an open loop waits this long past the close for late reads


@dataclasses.dataclass
class LoopStats:
    attempted: int = 0
    failed: int = 0
    never_done: int = 0
    window_s: float = 0.0
    host_s: list[float] = dataclasses.field(default_factory=list)  # per issued op
    lag_s: list[float] = dataclasses.field(default_factory=list)  # open loop
    latency_s: list[float] = dataclasses.field(default_factory=list)  # open loop

    @property
    def done(self) -> int:
        return self.attempted - self.failed - self.never_done


@dataclasses.dataclass
class Readings:
    """What a metric reader may read."""

    cfg: dict
    peaks: dict | None
    setup_s: float
    credit_bytes: int
    blocks_per_op: int
    stripes_per_op: int
    window: LoopStats  # trace 0: the window; trace 1: its unprofiled part
    traced: LoopStats | None = None  # trace 1: the profiled part
    device: devtrace.DeviceTrace | None = None
    counters: dict[str, float] | None = None
    counted_ops: int = 0

    def window_GBps(self) -> float | None:
        """The bytes the window's finished operations did (``credit_bytes``
        each) over the whole window's seconds, in GB/s."""
        w = self.window
        if w.window_s <= 0 or w.done == 0:
            return None
        return w.done * self.credit_bytes / w.window_s / 1e9


class _Peek:
    def __init__(self, it):
        self._it, self._head = it, None

    def peek(self):
        if self._head is None:
            self._head = next(self._it)
        return self._head

    def next(self):
        head = self.peek()
        self._head = None
        return head


def _mark(device: torch.device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _label(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _failure(stats: LoopStats, err: Exception) -> None:
    stats.failed += 1
    if stats.failed == 1:
        print("perfbench: an operation failed:", file=sys.stderr)
        traceback.print_exception(err, file=sys.stderr)


def closed_loop(drv, ops: _Peek, seconds: float, inflight: int, device: torch.device,
                labels: bool = False) -> LoopStats:
    stats = LoopStats()
    pending: list = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if len(pending) >= inflight:
            with _label(labels, "perfbench.wait"):
                ev = pending.pop(0)
                if ev is not None:
                    ev.synchronize()
        op = ops.next()
        stats.attempted += 1
        t = time.perf_counter()
        try:
            with _label(labels, "perfbench.issue"):
                out = drv.issue(op)
        except Exception as err:  # noqa: BLE001 - a failed operation is counted, the run goes on
            _failure(stats, err)
            continue
        stats.host_s.append(time.perf_counter() - t)
        pending.append(_mark(device))
        drv.keep(op, out)
        del out
    _sync(device)
    stats.window_s = time.perf_counter() - t0
    return stats


def _done(mark) -> bool:
    return mark is None or mark.query()


def open_loop(drv, sched: _Peek, seconds: float, device: torch.device,
              labels: bool = False) -> LoopStats:
    stats = LoopStats()
    waiting: list[tuple[float, object, int]] = []  # (due, completion mark, read)
    latency: list[float] = []

    def poll() -> None:
        """Stamp every read whose completion the host can now see."""
        if not waiting:
            return
        still = []
        for due, mark, i in waiting:
            if _done(mark):
                latency[i] = time.perf_counter() - due
            else:
                still.append((due, mark, i))
        waiting[:] = still

    base = sched.peek()[0]
    t0 = time.perf_counter()
    while sched.peek()[0] - base < seconds:
        offset, op = sched.next()
        due = t0 + offset - base
        with _label(labels, "perfbench.idle"):
            # the client spins, and never sleeps: a host woken from sleep
            # issues its next read slower, by an amount that varies
            while due > time.perf_counter():
                poll()
        t = time.perf_counter()
        stats.lag_s.append(t - due)
        stats.attempted += 1
        latency.append(math.inf)
        try:
            with _label(labels, "perfbench.issue"):
                out = drv.issue(op)
        except Exception as err:  # noqa: BLE001 - a failed read is counted, the run goes on
            _failure(stats, err)
            continue
        stats.host_s.append(time.perf_counter() - t)
        waiting.append((due, _mark(device), len(latency) - 1))
        drv.keep(op, out)
        del out
        poll()
    stats.window_s = time.perf_counter() - t0
    with _label(labels, "perfbench.drain"):
        while waiting and time.perf_counter() - t0 < seconds + DONE_GRACE_S:
            poll()
    stats.never_done = len(waiting)
    stats.latency_s = latency
    return stats


def describe(stats: LoopStats) -> str:
    """One line on how steady the host was in a loop, for standard error."""
    def pct(values: list[float], q: float) -> float:
        values = sorted(values)
        return values[min(len(values) - 1, int(q * len(values)))] * 1e3 if values else math.nan

    line = (f"{stats.attempted} ops in {stats.window_s:.3f} s; host ms a call p50 "
            f"{pct(stats.host_s, 0.5):.3f} p99 {pct(stats.host_s, 0.99):.3f} max "
            f"{pct(stats.host_s, 1.0):.3f}")
    if stats.lag_s:
        line += (f"; lag ms p50 {pct(stats.lag_s, 0.5):.3f} p99 {pct(stats.lag_s, 0.99):.3f}"
                 f" max {pct(stats.lag_s, 1.0):.3f}")
    return line


def _loop(drv, mix: dict, stream: _Peek, seconds: float, device: torch.device,
          labels: bool = False) -> LoopStats:
    if mix["loop"] == "closed":
        return closed_loop(drv, stream, seconds, int(mix["inflight"]), device, labels)
    if mix["loop"] == "open":
        return open_loop(drv, stream, seconds, device, labels)
    raise ValueError(f"unknown loop {mix['loop']!r}")


def _counters(drv, ops: list[dict], device: torch.device) -> dict[str, float]:
    """The program's ``obs`` counters over one pass of ``ops``, summed by name."""
    from repro_torch import obs

    with obs.tracing("perfbench") as tr:
        for op in ops:
            drv.issue(op)
        _sync(device)
    names = {name for name, _ in tr.metrics.counters}
    return {name: tr.counter_value(name) for name in names}


def _peaks(kind: str) -> dict | None:
    import json

    table = json.loads((Path(__file__).parent / "peaks.json").read_text())
    return table.get(kind)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, control=None, root: Path = spec.ROOT):
    """Run one cell; returns (result dict without ``checks``, the checks,
    the set-up split).  ``overrides`` replaces keys of the configuration
    (``"config"``) or the mix (``"mix"``), for tests at small sizes;
    ``control`` is a field whose reference takes the program's place."""
    t_start = time.perf_counter() if t_start is None else t_start
    split = {"python_imports": time.perf_counter() - t_start}
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = dict(spec.config(bench, cell["config"], root))
    mix = dict(spec.mix(cell["traffic"]))
    cfg.update((overrides or {}).get("config", {}))
    mix.update((overrides or {}).get("mix", {}))
    dev = torch.device(device)

    t = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        torch.zeros(1, device=dev)
        _sync(dev)
    split["cuda_init"] = time.perf_counter() - t

    drv = spec.driver(mix["entry"]).Driver(cfg, mix, seed, dev)
    split.update(drv.split)
    if control is not None:
        drv.use_control(control)
    distinct = traffic.all_ops(cfg, mix, seed)
    t = time.perf_counter()
    drv.warm(distinct)
    _sync(dev)
    counters = None
    if trace:
        devtrace.warm(lambda: drv.issue(distinct[0]), dev)
        counters = _counters(drv, distinct, dev)
    drv.arm()
    _sync(dev)
    # what set-up made lives for the whole run: the collector's full passes
    # in the window walk only what the window makes
    gc.collect()
    gc.freeze()
    split["warm"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    stream = _Peek(traffic.schedule(cfg, mix, seed) if mix["loop"] == "open"
                   else traffic.ops(cfg, mix, seed))
    profiled = named = dtrace = None
    gaps: list = []
    try:
        if trace:
            part, names = min(PROFILED_S, seconds / 2), min(GAPS_S, seconds / 4)
            window = _loop(drv, mix, stream, seconds - part - names, dev)
            profiled, dtrace = devtrace.profile(
                lambda: _loop(drv, mix, stream, part, dev), dev)
            named, gaps = devtrace.gap_names(
                lambda: _loop(drv, mix, stream, names, dev, labels=True), dev)
        else:
            window = _loop(drv, mix, stream, seconds, dev)
        _sync(dev)
    finally:
        gc.unfreeze()
    for name, stats in (("window", window), ("profiled", profiled), ("gap names", named)):
        if stats is not None:
            print(f"perfbench: {name}: {describe(stats)}", file=sys.stderr)
    if dtrace is not None and profiled.done and window.window_s > 0:
        # the idle share the unprofiled rate implies, beside the traced one
        busy_per_op = dtrace.busy_s / profiled.done
        implied = 1.0 - busy_per_op * window.done / window.window_s
        print(f"perfbench: idle traced {100 * (1 - dtrace.busy_s / dtrace.window_s):.2f}%, "
              f"implied by the unprofiled rate {100 * implied:.2f}% "
              f"({window.done / window.window_s:.3f} ops/s untraced, "
              f"{profiled.done / dtrace.window_s:.3f} traced)", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    loops = [window] + [s for s in (profiled, named) if s is not None]
    checks = drv.judge()
    checks.append(Check("ops_failed", sum(s.failed for s in loops), limit=0))
    checks.append(Check("ops_never_done", sum(s.never_done for s in loops), limit=0))

    readings = Readings(
        cfg=cfg, peaks=_peaks(kind), setup_s=setup_s,
        credit_bytes=drv.credit_bytes, blocks_per_op=drv.blocks_per_op,
        stripes_per_op=drv.stripes_per_op, window=window, traced=profiled,
        device=dtrace, counters=counters, counted_ops=len(distinct))
    metrics = {}
    for m in spec.metrics_of(bench, workload, "per_layer" if trace else "end_to_end"):
        value = spec.metric_reader(m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": sum(s.attempted for s in loops),
        "failed": sum(s.failed + s.never_done for s in loops),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)},
    }
    if trace and dtrace is not None:
        result["device"]["busy_s"] = dtrace.busy_s
        result["device"]["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(),
                               "idle_gaps": [[n, s] for n, s in gaps]}
    return result, checks, split
