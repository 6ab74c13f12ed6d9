"""Observability for the port: so far the metrics registry only.

Span tracing and the device-profile adapter of the reference's ``obs``
come with the serving slice.
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

__all__ = [
    "POW2_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "default_registry",
    "set_default_registry",
]
