"""Observability (the port of lightgbm_tpu/obs/), all host-side, never
inside a captured CUDA graph:

- ``metrics`` — the metrics registry (counters / gauges / histograms
  with labels) with Prometheus text exposition, served on /metrics;
- ``tracing`` — span tracing on the phase timer, exported as Chrome
  trace-event JSON and a JSONL event log;
- ``manifest`` — the per-run manifest JSON;
- ``recorder`` — the flight recorder: one JSONL record per boosting
  round, behind the ``record_file=`` param;
- ``anomaly`` — sentinels over the flight-record stream behind
  ``anomaly_policy=off|warn|abort|rollback``;
- ``aggregate`` — many processes' snapshots, scrapes and flight-record
  streams merged into one view (the gateway's merged /metrics).
"""

from . import aggregate, anomaly, manifest, metrics, recorder, tracing
from .anomaly import AnomalyAbort, AnomalySentinel
from .manifest import build_manifest, write_manifest
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Sample,
    default_registry,
)
from .recorder import FlightRecorder

# tracing's context manager is reached as `tracing.tracing(...)`:
# re-exporting the function here would shadow the submodule
from .tracing import TraceRecorder, span, start_tracing, stop_tracing

__all__ = [
    "AnomalyAbort",
    "AnomalySentinel",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Sample",
    "TraceRecorder",
    "aggregate",
    "anomaly",
    "build_manifest",
    "default_registry",
    "manifest",
    "metrics",
    "recorder",
    "span",
    "start_tracing",
    "stop_tracing",
    "tracing",
    "write_manifest",
]
