"""Observability layer: tick-clocked tracing + metrics for the serving
fleet.

* :mod:`repro_torch.orchestrator.obs.metrics` -- per-pod :class:`MetricsRegistry`
  (counters / gauges / fixed-bucket histograms) with deterministic
  snapshots and fleet-level aggregation.
* :mod:`repro_torch.orchestrator.obs.tracing` -- per-request lifecycle span
  events in bounded ring buffers, exportable to Chrome trace-event JSON
  (Perfetto-openable via ``serve --trace out.json``).
* :mod:`repro_torch.orchestrator.obs.report` -- TTFT / inter-token-latency
  decomposition derived from spans, plus the span-log -> registry
  recompute used to check bitwise reproducibility.
"""

from repro_torch.orchestrator.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_snapshots,
    snapshot_count,
    snapshot_exemplar,
    snapshot_percentile,
    snapshot_total,
)
from repro_torch.orchestrator.obs.report import (
    ITL_HIST,
    TICK_HIST,
    completion_snapshot,
    decomposition,
    itl_milliticks,
    observe_completion,
    recompute_registry,
    request_lifecycles,
)
from repro_torch.orchestrator.obs.tracing import (
    SPAN_KINDS,
    SPAN_TRANSITIONS,
    TERMINAL_SPANS,
    SpanEvent,
    TraceBuffer,
    dump_span_log,
    export_chrome,
    load_span_log,
    validate_chrome_trace,
    validate_fleet_closure,
    validate_span_log,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "merge_snapshots", "snapshot_count", "snapshot_percentile",
    "snapshot_total",
    "TICK_HIST", "ITL_HIST", "completion_snapshot", "decomposition",
    "itl_milliticks", "observe_completion", "recompute_registry",
    "request_lifecycles", "snapshot_exemplar",
    "SPAN_KINDS", "SPAN_TRANSITIONS", "TERMINAL_SPANS", "SpanEvent",
    "TraceBuffer", "dump_span_log", "export_chrome", "load_span_log",
    "validate_chrome_trace", "validate_fleet_closure", "validate_span_log",
]
