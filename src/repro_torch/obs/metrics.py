"""Typed counters and gauges for ``repro_torch.obs``.

Two metric kinds, both labelled:

* **Counter** — monotonically accumulating (``counter_add``): bytes
  moved inner- vs cross-rack, GF multiply bytes, units sent per relayer.
* **Gauge** — last-write-wins (``gauge_set``): the recovery throughput
  and degraded-read latency of a simulated run.

A metric instance is keyed by ``(name, sorted labels)``.  Every counter
update is also journalled with a timestamp so the Chrome-trace exporter
can render counter tracks (``"ph": "C"``) alongside the spans.

Aggregation rules used by the summary exporter and ``counter_value``:
counters sum across label sets of the same name; gauges never aggregate
(each label set reports its own last value).
"""
from __future__ import annotations

import threading
from typing import Callable, NamedTuple

LabelKey = tuple[tuple[str, str], ...]


def _key(labels: dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def label_str(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key) if key else ""


class CounterEvent(NamedTuple):
    """One journalled counter update (cumulative value after the add)."""

    ts_us: float
    name: str
    labels: LabelKey
    value: float


class MetricSet:
    """Thread-safe counter/gauge store attached to one Tracer."""

    def __init__(self, clock_us: Callable[[], float]):
        self._clock_us = clock_us
        self._lock = threading.Lock()
        self.counters: dict[tuple[str, LabelKey], float] = {}
        self.gauges: dict[tuple[str, LabelKey], float] = {}
        self.counter_events: list[CounterEvent] = []

    # ------------------------------------------------------------ counters
    def counter_add(self, name: str, value: float, **labels: str) -> None:
        if value < 0:
            raise ValueError(f"counter {name!r} add must be >= 0, got {value}")
        k = (name, _key(labels))
        with self._lock:
            new = self.counters.get(k, 0.0) + value
            self.counters[k] = new
            self.counter_events.append(
                CounterEvent(self._clock_us(), name, k[1], new)
            )

    def counter_value(self, name: str, **labels: str) -> float:
        """Current value; with no labels given, sums all label sets."""
        with self._lock:
            if labels:
                return self.counters.get((name, _key(labels)), 0.0)
            return sum(v for (n, _), v in self.counters.items() if n == name)

    # -------------------------------------------------------------- gauges
    def gauge_set(self, name: str, value: float, **labels: str) -> None:
        with self._lock:
            self.gauges[(name, _key(labels))] = float(value)

    def gauge_value(self, name: str, **labels: str) -> float | None:
        with self._lock:
            return self.gauges.get((name, _key(labels)))

    # ------------------------------------------------------------- export
    def as_dict(self) -> dict[str, dict[str, dict[str, float]]]:
        """{"counters": {name: {label_str: value}}, "gauges": {...}}."""
        with self._lock:
            out: dict[str, dict[str, dict[str, float]]] = {
                "counters": {}, "gauges": {}
            }
            for (name, key), v in sorted(self.counters.items()):
                out["counters"].setdefault(name, {})[label_str(key)] = v
            for (name, key), v in sorted(self.gauges.items()):
                out["gauges"].setdefault(name, {})[label_str(key)] = v
            return out
