"""The device's side of a traced run: ``torch.profiler`` over a stretch of the
window, reduced to busy time, kernel time by name and the idle gaps.

``profile`` records the card's activity alone (CUPTI), so the host runs as
it does untraced and the busy share is the program's; ``gap_names`` records
the host's operations too, in a short stretch of its own that no metric
reads, to name what the host did in each idle gap.  Each stretch opens on
a synchronised card with a one-byte marker fill and closes with another
before it synchronises: its window runs from the start of the first device
operation to the end of the last.  The trace is written to a temporary file
under ``TMPDIR``, read and deleted.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Callable

import torch

from .drivers.common import sync as _sync

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    device_s: float  # summed durations of every device operation
    by_name: dict[str, float]  # device seconds by operation name
    gaps: list[tuple[str, float]]  # the longest idle gaps, by what the host did midway

    def seconds_matching(self, part: str) -> float:
        return sum(s for name, s in self.by_name.items() if part in name)

    def top_ops(self) -> list[list]:
        ranked = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name, s] for name, s in ranked]


def _short(name: str) -> str:
    """A device operation's name without its parameter list."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:160]


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _host_at(host: list[tuple[float, float, str]], t: float) -> str:
    """The innermost host event that spans time ``t``."""
    best, best_len = "host idle", float("inf")
    for a, b, name in host:
        if a <= t <= b and b - a < best_len:
            best, best_len = name, b - a
    return best


def reduce(trace: dict) -> DeviceTrace | None:
    """Reduce a Chrome trace of one stretch; None if it holds no device
    operation."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    dev = []
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        dev.append((a, b))
        key = _short(e.get("name", "?"))
        by_name[key] = by_name.get(key, 0.0) + (b - a) * 1e-6
    if not dev:
        return None
    busy = _merge(dev)
    w0, w1 = busy[0][0], busy[-1][1]
    idle = sorted(((busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)),
                  key=lambda g: g[0] - g[1])[:TOP]
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", "?"))
            for e in events if e.get("cat") in HOST_CATS]
    gaps = [(_host_at(host, (a + b) / 2), (b - a) * 1e-6) for a, b in idle]
    return DeviceTrace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_s=sum(b - a for a, b in dev) * 1e-6,
        by_name=by_name,
        gaps=gaps,
    )


def _activities(device: torch.device, host: bool) -> list:
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        return [ProfilerActivity.CPU]
    return [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]


def _marker(device: torch.device) -> None:
    torch.zeros(1, dtype=torch.uint8, device=device)


def _traced(fn: Callable[[], object], device: torch.device, host: bool):
    from torch.profiler import profile as _profile

    _sync(device)
    with _profile(activities=_activities(device, host)) as prof:
        _marker(device)
        out = fn()
        _marker(device)
        _sync(device)
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.unlink(path)
    return out, reduce(trace)


def profile(fn: Callable[[], object], device: torch.device):
    """(fn(), DeviceTrace or None) with ``fn`` run under the profiler,
    recording the card's activity alone."""
    return _traced(fn, device, host=False)


def gap_names(fn: Callable[[], object], device: torch.device):
    """(fn(), the longest idle gaps named by what the host did midway), with
    the host's operations recorded too: for the breakdown only."""
    out, trace = _traced(fn, device, host=True)
    return out, (trace.gaps if trace is not None else [])


def warm(fn: Callable[[], object], device: torch.device) -> None:
    """Start and stop the profiler in both set-ups around ``fn``, so its
    own initialisation falls in set-up and not in a traced stretch."""
    for host in (False, True):
        _traced(fn, device, host)
