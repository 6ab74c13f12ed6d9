"""Observability for the port: the metrics registry and span tracing,
dependency-free and zero-cost when disabled.

  * :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` of counters,
    gauges and fixed power-of-two-bucket histograms keyed by the serving
    layer's (code, path, F-rung, T-rung) cell labels, with Prometheus
    text and plain-dict snapshot exporters.
  * :mod:`repro_torch.obs.trace` — ``SpanRecorder``/``span(...)`` nested
    spans with a JSONL event-log sink, and the decode paths' stages
    (``stage``, ``host_read``, ``stage_totals``) on the default recorder
    and the profiler's trace.

``Observability`` bundles one registry and one recorder (and an optional
JSONL sink) for handing to ``DecodeEngine``; the module-level
``default_registry()`` is a ``NullRegistry`` until one is installed, so
library-level instrumentation (the decoder's path counters) costs
nothing by default; ``default_recorder()`` is likewise a
``NullRecorder`` until one is installed, and the decode stages cost two
flag checks while neither it nor a profiler session is on.

  * :mod:`repro_torch.obs.profile` — ``dispatch_profile``: modelled
    device-memory bytes, operations and trip-count depth per engine
    dispatch, priced on the H100 roofline (``roofline.H100``); the
    engine attaches it to its dispatch spans when tracing is on.

CLI entry points: ``python -m repro_torch.obs.top`` (terminal snapshot)
and ``python -m repro_torch.obs.smoke`` (the gate).
"""
from __future__ import annotations

from typing import Optional

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
from repro_torch.obs.profile import DispatchProfile, dispatch_profile
from repro_torch.obs.trace import (
    JsonlSink,
    NullRecorder,
    Span,
    SpanRecorder,
    default_recorder,
    host_read,
    reset_stage_totals,
    set_default_recorder,
    stage,
    stage_totals,
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
    "default_recorder",
    "set_default_recorder",
    "stage",
    "host_read",
    "stage_totals",
    "reset_stage_totals",
    "DispatchProfile",
    "dispatch_profile",
    "Observability",
]


class Observability:
    """One registry and one recorder, wired together.

    ``Observability(jsonl=path)`` opens a :class:`JsonlSink` shared by
    the recorder (span and event lines) and :meth:`dump_metrics` (metrics
    lines): one event log in one file.  With ``enabled=False`` the
    recorder is the shared no-op and no sink is opened; the registry
    stays real (it is cheap and backs ``stats()``-style accessors).
    """

    def __init__(self, enabled: bool = True, jsonl: Optional[str] = None,
                 clock=None, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.sink = JsonlSink(jsonl) if (jsonl and enabled) else None
        if enabled:
            kw = {"sink": self.sink}
            if clock is not None:
                kw["clock"] = clock
            self.recorder: SpanRecorder = SpanRecorder(**kw)
        else:
            self.recorder = NullRecorder()

    @property
    def enabled(self) -> bool:
        return self.recorder.enabled

    def dump_metrics(self) -> None:
        """Append one ``{"type": "metrics", ...}`` snapshot line to the
        JSONL sink (a no-op without a sink)."""
        if self.sink is not None:
            self.sink.write(
                {"type": "metrics", "data": self.registry.snapshot()}
            )

    def close(self) -> None:
        self.dump_metrics()
        if self.sink is not None:
            self.sink.close()
