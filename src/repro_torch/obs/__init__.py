"""``repro_torch.obs`` — span tracing + metrics for the repair pipeline.

The measurement substrate every layer shares (paper §6 methodology):
the repair-plan executor, the cluster simulator, the GF(256) kernels and
the benchmark drivers all emit the *same* stage schema —

    disk → node_encode → inner → relayer_encode → cross → decode → write

— as spans, plus typed counters (bytes inner-/cross-rack, GF multiply
bytes, units per relayer) and gauges (achieved GB/s), so simulated and
measured runs are directly comparable in one Chrome trace.

Usage::

    from repro_torch import obs

    with obs.tracing("my-run") as tr:
        code.repair(0, payloads)            # library code self-instruments
    obs.write_chrome_trace(tr, "trace.json")   # chrome://tracing
    print(obs.summary(tr))

All module-level helpers (`span`, `counter_add`, `gauge_set`,
`record_span`) are no-ops costing one global read when no tracer is
active — instrumented hot paths pay nothing measurable while tracing
is off.
"""
from .export import (
    spans_from_chrome,
    summary,
    to_chrome_trace,
    write_chrome_trace,
    write_summary,
)
from .metrics import CounterEvent, MetricSet
from .tracer import (
    NULL_SPAN,
    Span,
    Tracer,
    counter_add,
    current,
    enabled,
    gauge_set,
    record_span,
    span,
    tracing,
)

# Canonical stage-span names: keep in lock-step with
# repro.storage.simulator.StageTimes.as_dict() in the reference package.
STAGE_NAMES = (
    "disk", "node_encode", "inner", "relayer_encode", "cross", "decode",
    "write",
)

__all__ = [
    "CounterEvent", "MetricSet", "NULL_SPAN", "STAGE_NAMES", "Span",
    "Tracer", "counter_add", "current", "enabled", "gauge_set",
    "record_span", "span", "spans_from_chrome", "summary", "to_chrome_trace",
    "tracing", "write_chrome_trace", "write_summary",
]
