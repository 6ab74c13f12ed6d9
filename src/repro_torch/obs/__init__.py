"""Observability for the port: the metrics registry and span tracing.

The reference's device-profile adapter (``obs/profile.py``), ``obs/top``
and ``obs/smoke`` are not ported yet.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (
    POW2_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    default_registry,
    set_default_registry,
)
from repro_torch.obs.trace import (
    JsonlSink,
    NullRecorder,
    Span,
    SpanRecorder,
)

__all__ = [
    "POW2_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "default_registry",
    "set_default_registry",
    "Span",
    "SpanRecorder",
    "NullRecorder",
    "JsonlSink",
]
