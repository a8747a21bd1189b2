"""repro_torch.mining.telemetry — latency histograms, request trace spans,
and a periodic stats emitter for the serving stack.

  - :mod:`.hist` — ``LatencyHistogram`` (fixed log buckets, mergeable,
    thread-safe, exact counts, p50/p95/p99 from bucket edges) plus the
    ``Registry`` of named histograms/counters/gauges (one per
    ``MiningEngine``, at ``engine.telemetry``);
  - :mod:`.trace` — per-request span trees behind a ``failures``-style
    global attach/detach, exported as JSON or Chrome trace events; the
    same spans become ``torch.profiler`` ranges and fill a per-name table
    (``profiled()``) while the profiler records. With neither active a
    span site costs one global read and one C call;
  - :mod:`.emit` — ``StatsEmitter``, a background JSON-lines snapshot
    loop with chaos-point drop containment (``telemetry.emit``).
"""
from .emit import StatsEmitter
from .hist import (
    DEFAULT_EDGES,
    SCHEMA_VERSION,
    Counter,
    Gauge,
    LatencyHistogram,
    Registry,
)
from .trace import TraceRecorder, active, attach, attached, current_span, span

__all__ = [
    "DEFAULT_EDGES",
    "SCHEMA_VERSION",
    "Counter",
    "Gauge",
    "LatencyHistogram",
    "Registry",
    "StatsEmitter",
    "TraceRecorder",
    "active",
    "attach",
    "attached",
    "current_span",
    "span",
]
