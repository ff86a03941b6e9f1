"""Observability of the port: tracing, metrics, fixpoint probes, roofline.

One low-overhead layer threaded through the query path (admission →
coalesce → launch_batch → fixpoint → finalize_batch → cache-fill), as in
``repro.obs``:

- :mod:`.trace` — per-query/per-batch spans, Chrome ``trace_event`` export
- :mod:`.metrics` — thread-safe counter/gauge/histogram registry with
  Prometheus-text and JSON exporters, absorbing the stats dataclasses
- :mod:`.fixpoint_probe` — opt-in probed fixpoint twins exposing
  per-iteration frontier sizes and semi-naive Δ-fact counts
- :mod:`.roofline_attr` — achieved-vs-peak attribution per kernel launch,
  scored against the H100 model
"""
from .trace import NULL_TRACER, NullTracer, Span, Tracer
from .metrics import (
    DEFAULT_BUCKETS, NULL_METRICS, Counter, Gauge, Histogram,
    MetricsRegistry, NullMetrics,
)
from .fixpoint_probe import (
    FixpointProbe, fixpoint_csr_probed, fixpoint_dense_probed,
)
from .roofline_attr import KernelAttribution, csr_launch_cost, dense_launch_cost

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "MetricsRegistry", "NullMetrics", "NULL_METRICS",
    "Counter", "Gauge", "Histogram", "DEFAULT_BUCKETS",
    "FixpointProbe", "fixpoint_dense_probed", "fixpoint_csr_probed",
    "KernelAttribution", "dense_launch_cost", "csr_launch_cost",
]
