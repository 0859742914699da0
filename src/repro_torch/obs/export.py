"""Exporters for ``repro_torch.obs``: JSON summaries + Chrome ``trace_event``.

Chrome format (load in chrome://tracing or https://ui.perfetto.dev):

* each `Span` becomes a complete event (``"ph": "X"``) with ``ts``/``dur``
  in microseconds; the span's track maps to a stable integer ``tid``
  whose human name is emitted as ``thread_name`` metadata;
* span ids/parent ids and user attrs ride in ``args`` so the export is
  lossless — `spans_from_chrome` rebuilds the span list for round-trip
  tests and offline analysis;
* journalled counter updates become counter events (``"ph": "C"``), one
  track per counter name, one series per label set.

The JSON summary aggregates per span name (count/total/mean/max) and
dumps final counter/gauge values — the compact artifact benchmarks
persist next to their CSV results.
"""
from __future__ import annotations

import json
from typing import Any

from .metrics import label_str
from .tracer import Span, Tracer

_PID = 0


def _track_ids(tracer: Tracer) -> dict[str, int]:
    tracks: dict[str, int] = {}
    for s in tracer.spans:
        tracks.setdefault(s.track, len(tracks))
    return tracks


def to_chrome_trace(tracer: Tracer) -> dict[str, Any]:
    tracks = _track_ids(tracer)
    events: list[dict[str, Any]] = [
        {"ph": "M", "pid": _PID, "name": "process_name",
         "args": {"name": tracer.name}},
    ]
    for track, tid in tracks.items():
        events.append({"ph": "M", "pid": _PID, "tid": tid,
                       "name": "thread_name", "args": {"name": track}})
    for s in tracer.spans:
        args = dict(s.attrs)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({
            "ph": "X", "pid": _PID, "tid": tracks[s.track],
            "name": s.name, "cat": s.cat or "default",
            "ts": s.start_us, "dur": s.dur_us, "args": args,
        })
    ctid = len(tracks)
    for ev in tracer.metrics.counter_events:
        series = label_str(ev.labels) or "value"
        events.append({
            "ph": "C", "pid": _PID, "tid": ctid, "name": ev.name,
            "ts": ev.ts_us, "args": {series: ev.value},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_from_chrome(obj: dict[str, Any]) -> list[Span]:
    """Inverse of `to_chrome_trace` for the "X" events (round-trip tests)."""
    names: dict[int, str] = {}
    for ev in obj["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev["tid"]] = ev["args"]["name"]
    spans: list[Span] = []
    for ev in obj["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        span_id = args.pop("span_id")
        parent_id = args.pop("parent_id", None)
        cat = ev.get("cat", "")
        spans.append(Span(
            span_id, parent_id, ev["name"],
            "" if cat == "default" else cat,
            names.get(ev["tid"], str(ev["tid"])),
            ev["ts"], ev["dur"], args,
        ))
    spans.sort(key=lambda s: s.span_id)
    return spans


def summary(tracer: Tracer) -> dict[str, Any]:
    by_name: dict[str, dict[str, Any]] = {}  # count/*_us floats + "cat" str
    for s in tracer.spans:
        agg = by_name.setdefault(s.name, {
            "count": 0, "total_us": 0.0, "max_us": 0.0, "cat": s.cat
        })
        agg["count"] += 1
        agg["total_us"] += s.dur_us
        agg["max_us"] = max(agg["max_us"], s.dur_us)
    for agg in by_name.values():
        agg["mean_us"] = agg["total_us"] / agg["count"]
    out: dict[str, Any] = {"trace": tracer.name, "spans": by_name}
    out.update(tracer.metrics.as_dict())
    return out


def write_chrome_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer), f, indent=1)
    return path


def write_summary(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(summary(tracer), f, indent=1, sort_keys=True)
    return path
