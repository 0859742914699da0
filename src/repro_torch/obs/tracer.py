"""Span tracer: nested, monotonic, thread-aware — the timing half of
``repro_torch.obs``.

A `Tracer` collects `Span` records on a single monotonic timebase
(microseconds since the tracer's epoch).  The epoch is also read once on the
Unix clock, so `Tracer.unix_us` puts a span on the timeline a
``torch.profiler`` trace exports (its ``ts`` plus ``baseTimeNanoseconds /
1000`` is Unix-epoch microseconds): a span and the device work it launched
can be read together.  Spans come from two sources:

* **measured** — ``tracer.span(name)`` context managers wrap real work
  and record wall-clock via ``time.monotonic_ns``; nesting is tracked
  per-thread, so concurrent threads produce independent span stacks that
  land on separate tracks;
* **synthetic** — ``tracer.record_span(name, dur_s, ...)`` injects a
  span with an explicit duration (and optionally an explicit start) so
  *simulated* stage times (the storage simulator) share the same schema
  and trace files as measured spans.

Activation is process-global (one tracer at a time, activations nest)
while the span *stack* is thread-local — so library code (repair
execution, the simulator, the GF kernels) records spans and counters
without plumbing a tracer argument through every call, and worker
threads spawned under an active tracer record into it too.  When no
tracer is active every module-level helper is a no-op that costs one
global read.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Any, Iterator

from .metrics import MetricSet

_active: "Tracer | None" = None
_active_lock = threading.Lock()


class Span:
    """One timed (or synthetic) interval.  Times are µs since tracer epoch."""

    __slots__ = ("span_id", "parent_id", "name", "cat", "track",
                 "start_us", "dur_us", "attrs")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 cat: str, track: str, start_us: float, dur_us: float,
                 attrs: dict[str, Any]):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.cat = cat
        self.track = track
        self.start_us = start_us
        self.dur_us = dur_us
        self.attrs = attrs

    def set_attr(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    @property
    def dur_s(self) -> float:
        return self.dur_us / 1e6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, cat={self.cat!r}, track={self.track!r}, "
                f"start={self.start_us:.1f}us, dur={self.dur_us:.1f}us)")


class _NullSpan(contextlib.AbstractContextManager["_NullSpan"]):
    """Shared no-op stand-in returned while tracing is disabled."""

    __slots__ = ()

    def set_attr(self, key: str, value: Any) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Measured(contextlib.AbstractContextManager[Span]):
    """One measured span's context: the span opens on entry, on the calling
    thread's stack, and is timed and recorded on exit (a class rather than a
    generator: instrumented hot paths open one per call)."""

    __slots__ = ("_tracer", "_name", "_cat", "_attrs", "_span", "_stack")

    def __init__(self, tracer: "Tracer", name: str, cat: str, attrs: dict[str, Any]):
        self._tracer, self._name, self._cat, self._attrs = tracer, name, cat, attrs

    def __enter__(self) -> Span:
        t = self._tracer
        stack = self._stack = t._stack()
        parent = stack[-1].span_id if stack else None
        s = self._span = Span(next(t._ids), parent, self._name, self._cat,
                              threading.current_thread().name, t.now_us(), 0.0,
                              self._attrs)
        stack.append(s)
        return s

    def __exit__(self, *exc: object) -> None:
        t, s = self._tracer, self._span
        s.dur_us = t.now_us() - s.start_us
        self._stack.pop()
        with t._lock:
            t.spans.append(s)


class Tracer:
    """Collects spans + metrics for one traced run.  Thread-safe."""

    def __init__(self, name: str = "trace"):
        self.name = name
        self._prev: Tracer | None = None  # tracer shadowed by this activation
        # the Unix clock read between two monotonic reads: the epoch on both
        # clocks, to within half the time between them
        t0, self.epoch_unix_ns, t1 = time.monotonic_ns(), time.time_ns(), time.monotonic_ns()
        self.epoch_ns = (t0 + t1) // 2
        self.spans: list[Span] = []
        self.metrics = MetricSet(clock_us=self.now_us)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._tls = threading.local()  # per-thread span stack
        self._cursors: dict[str, float] = {}  # synthetic-track layout cursors
        self._seq = itertools.count(1)

    # ------------------------------------------------------------ timebase
    def now_us(self) -> float:
        return (time.monotonic_ns() - self.epoch_ns) / 1e3

    def unix_us(self, t_us: float) -> float:
        """A time on this tracer's timeline (µs since its epoch) as Unix-epoch
        µs, the clock of an exported ``torch.profiler`` trace."""
        return self.epoch_unix_ns / 1e3 + t_us

    def next_seq(self) -> int:
        """Monotonic sequence number (e.g. to name one track per operation)."""
        return next(self._seq)

    # ------------------------------------------------------------- spans
    def _stack(self) -> list[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_span(self) -> Span | None:
        stack = self._stack()
        return stack[-1] if stack else None

    def span(self, name: str, cat: str = "", **attrs: Any) -> "_Measured":
        """Measured span: times the enclosed block, nests per-thread."""
        return _Measured(self, name, cat, attrs)

    def record_span(self, name: str, dur_s: float, *, cat: str = "",
                    track: str | None = None, at_s: float | None = None,
                    **attrs: Any) -> Span:
        """Synthetic span with an externally-supplied duration.

        ``at_s`` places the span at an explicit start offset (seconds on
        the tracer timeline).  Without it, spans on the same ``track``
        are laid out back-to-back from that track's cursor — this is how
        the simulator renders its sequential stage pipeline; tracks
        default to the calling thread (span ends "now", i.e. it times an
        interval that just finished).
        """
        cur = self.current_span()
        parent = cur.span_id if cur is not None else None
        dur_us = dur_s * 1e6
        if at_s is not None:
            start_us = at_s * 1e6
            track = track or threading.current_thread().name
        elif track is not None:
            with self._lock:
                start_us = self._cursors.get(track, 0.0)
                self._cursors[track] = start_us + dur_us
        else:
            track = threading.current_thread().name
            start_us = self.now_us() - dur_us
        s = Span(next(self._ids), parent, name, cat, track, start_us,
                 dur_us, attrs)
        with self._lock:
            self.spans.append(s)
        return s

    # ------------------------------------------------------------ metrics
    def counter_add(self, name: str, value: float, **labels: str) -> None:
        self.metrics.counter_add(name, value, **labels)

    def gauge_set(self, name: str, value: float, **labels: str) -> None:
        self.metrics.gauge_set(name, value, **labels)

    def counter_value(self, name: str, **labels: str) -> float:
        return self.metrics.counter_value(name, **labels)

    # ------------------------------------------------------------ queries
    def spans_named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def spans_in_cat(self, cat: str) -> list[Span]:
        return [s for s in self.spans if s.cat == cat]

    # --------------------------------------------------------- activation
    def __enter__(self) -> "Tracer":
        global _active
        with _active_lock:
            self._prev = _active
            _active = self
        return self

    def __exit__(self, *exc: object) -> None:
        global _active
        with _active_lock:
            _active = self._prev


# ---------------------------------------------------------------- module API
def current() -> Tracer | None:
    """The active tracer, or None."""
    return _active


def enabled() -> bool:
    """True iff a tracer is active (library instrumentation keys off this)."""
    return _active is not None


@contextlib.contextmanager
def tracing(name: str = "trace") -> Iterator[Tracer]:
    """Create a Tracer and activate it for the enclosed block."""
    with Tracer(name) as t:
        yield t


def span(name: str, cat: str = "",
         **attrs: Any) -> contextlib.AbstractContextManager[Any]:
    """Span on the active tracer; a shared no-op when tracing is off."""
    t = _active
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, **attrs)


def record_span(name: str, dur_s: float, **kwargs: Any) -> Span | None:
    t = _active
    if t is None:
        return None
    return t.record_span(name, dur_s, **kwargs)


def counter_add(name: str, value: float, **labels: str) -> None:
    t = _active
    if t is not None:
        t.counter_add(name, value, **labels)


def gauge_set(name: str, value: float, **labels: str) -> None:
    t = _active
    if t is not None:
        t.gauge_set(name, value, **labels)
