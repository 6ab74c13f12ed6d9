"""Span/trace layer: nested spans and standalone events with a JSONL
exporter, a copy of the reference's ``obs/trace.py`` (pure Python).

A ``SpanRecorder`` holds a stack of open spans; ``span(...)`` is a
context manager that opens a child of whatever span is open, so the
serving engine's request lifecycle (enqueue -> assemble -> callable
lookup -> dispatch -> device wait -> emit) nests without threading span
objects through call signatures.  Durations come from the recorder's
injectable ``clock`` (default ``time.perf_counter``); virtual-clock
timestamps ride along as span attributes, never as the duration source.

Finished spans and standalone events go to a bounded in-memory buffer
and, when a sink is attached, out as one JSON object per line::

    {"type": "span", "name": ..., "id": ..., "parent": ..., "t0": ...,
     "t1": ..., "dur": ..., "attrs": {...}, "events": [...]}
    {"type": "event", "name": ..., "t": ..., "span": ..., "attrs": {...}}

``NullRecorder`` is the zero-cost twin: ``span()`` returns a shared
no-op context manager, so instrumented code pays one method call when
tracing is off.

On the card a span around a dispatch measures host time: it covers the
kernels only when it closes after the copy that waits for them (the
engine's ``engine.device_wait`` span closes after the ``.cpu()`` copy).
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import time
from typing import Dict, List, Optional

__all__ = [
    "Span",
    "SpanRecorder",
    "NullRecorder",
    "JsonlSink",
]


class Span:
    """One timed unit of work.  Mutable while open; ``set`` adds
    attributes, ``event`` appends a timestamped point-in-time record."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "attrs", "events",
                 "_rec")

    def __init__(self, name: str, sid: int, parent: Optional[int],
                 t0: float, rec: "SpanRecorder"):
        self.name = name
        self.id = sid
        self.parent = parent
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, object] = {}
        self.events: List[dict] = []
        self._rec = rec

    @property
    def duration(self) -> Optional[float]:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> None:
        self.events.append(
            {"name": name, "t": self._rec.clock(), "attrs": attrs}
        )

    def to_dict(self) -> dict:
        return {
            "type": "span",
            "name": self.name,
            "id": self.id,
            "parent": self.parent,
            "t0": self.t0,
            "t1": self.t1,
            "dur": self.duration,
            "attrs": self.attrs,
            "events": self.events,
        }


class _SpanCtx:
    """Context manager pairing ``SpanRecorder.start``/``end``."""

    __slots__ = ("_rec", "_span")

    def __init__(self, rec: "SpanRecorder", span: Span):
        self._rec = rec
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._span.set(error=repr(exc))
        self._rec.end(self._span)
        return False


class JsonlSink:
    """Appends one JSON object per line; parent directories are created
    (the ``experiments/obs/`` convention)."""

    def __init__(self, path: str):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    def write(self, record: dict) -> None:
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class SpanRecorder:
    """Explicit span lifecycle + the nesting stack (module docstring).

    Parameters
    ----------
    clock     : timestamp source for span durations and event times
                (injectable so tests are deterministic).
    sink      : optional ``JsonlSink``-like object; every finished span
                and standalone event is written through it immediately.
    max_spans : bound of the in-memory finished-span buffer (the sink,
                if any, still sees everything).
    """

    enabled = True

    def __init__(self, clock=time.perf_counter, sink=None,
                 max_spans: int = 65536):
        self.clock = clock
        self.sink = sink
        self.spans: "collections.deque[Span]" = collections.deque(
            maxlen=max_spans
        )
        self._stack: List[Span] = []
        self._ids = itertools.count(1)

    # -- explicit lifecycle ------------------------------------------------

    def start(self, name: str, **attrs) -> Span:
        parent = self._stack[-1].id if self._stack else None
        s = Span(name, next(self._ids), parent, self.clock(), self)
        if attrs:
            s.attrs.update(attrs)
        self._stack.append(s)
        return s

    def end(self, span: Span, **attrs) -> Span:
        if attrs:
            span.attrs.update(attrs)
        span.t1 = self.clock()
        # tolerate out-of-order ends defensively: pop through the span
        while self._stack:
            top = self._stack.pop()
            if top is span:
                break
        self.spans.append(span)
        if self.sink is not None:
            self.sink.write(span.to_dict())
        return span

    def span(self, name: str, **attrs) -> _SpanCtx:
        """``with rec.span("engine.dispatch", code=...) as sp:`` — the
        instrumentation entry point; nests under the open span."""
        return _SpanCtx(self, self.start(name, **attrs))

    def event(self, name: str, **attrs) -> None:
        """Standalone point-in-time record: attached to the open span
        when one exists, else a top-level ``event`` line."""
        if self._stack:
            self._stack[-1].event(name, **attrs)
            return
        rec = {
            "type": "event", "name": name, "t": self.clock(),
            "span": None, "attrs": attrs,
        }
        if self.sink is not None:
            self.sink.write(rec)

    @property
    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    @property
    def open_spans(self) -> int:
        return len(self._stack)

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()

    # -- queries (tests + smoke assertions) --------------------------------

    def find(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]


class _NullSpan:
    """Shared no-op span/context manager of the disabled recorder."""

    __slots__ = ()
    name = "null"
    id = 0
    parent = None
    t0 = t1 = 0.0
    duration = 0.0
    attrs: Dict[str, object] = {}
    events: List[dict] = []

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs) -> None:
        pass

    def to_dict(self) -> dict:
        return {}


_NULL_SPAN = _NullSpan()


class NullRecorder(SpanRecorder):
    """Zero-cost disabled recorder: every call returns the shared no-op
    span; nothing is buffered or written."""

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0, sink=None, max_spans=1)

    def start(self, name: str, **attrs):  # type: ignore[override]
        return _NULL_SPAN

    def end(self, span, **attrs):  # type: ignore[override]
        return _NULL_SPAN

    def span(self, name: str, **attrs):  # type: ignore[override]
        return _NULL_SPAN

    def event(self, name: str, **attrs) -> None:
        pass

    def close(self) -> None:
        pass
