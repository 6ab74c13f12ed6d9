"""Span/trace layer: nested spans and standalone events with a JSONL
exporter, a copy of the reference's ``obs/trace.py``, and the port's
decode stages on top of it (below).

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

**Decode stages.**  ``stage(name, device=None, **attrs)`` marks one stage
of the decode paths (``repro_torch.decode``, ``.front_door``,
``.window_gather``, ``.k1``-``.k3``, ``.forward``, ``.traceback``,
``.scan``, ``.recovery``, ``.alpha``, ``.beta``, ``.llr_combine``, the
list loops, ``.wava``).  It is active only while a ``torch.profiler``
session runs or while the process default recorder
(``set_default_recorder``) is enabled; otherwise it returns the shared
no-op span, at the cost of one call and two flag checks.  An active
stage

  * opens the host range ``repro_torch.<name>`` in the profiler's trace,
    on the clock of the device's kernels.  The range is of the
    profiler's function scope: a user-scope range
    (``torch.profiler.record_function``) also gets an image on the
    device timeline, which a trace reader would count as a kernel;
  * opens the span ``repro_torch.<name>`` on the default recorder, a
    child of whatever span is open there;
  * on a CUDA ``device``, records a timing event on its current stream
    at entry and at exit; once the device has passed both, their
    distance is the stage's ``device_s`` (how long the stage held the
    stream), set on the span and added to the totals;
  * adds to ``stage_totals()[name]``: ``device_s``, ``steps`` (the
    ``steps=`` attribute: iterations of a plain per-step loop),
    ``circulations`` (the ``circulations=`` attribute: WAVA's passes
    over the circular trellis) and ``host_syncs`` (``host_read`` and
    ``host_upload`` calls while the stage was the innermost open one:
    the sites that block the host until the card's stream drains,
    counted on every device).

Counts are attributes given once per stage, never per loop step.  A
span's JSONL line is written at its end, before its ``device_s`` is
known; the in-memory span and the totals carry it.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "Span",
    "SpanRecorder",
    "NullRecorder",
    "JsonlSink",
    "default_recorder",
    "set_default_recorder",
    "stage",
    "host_read",
    "host_upload",
    "stage_totals",
    "reset_stage_totals",
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


# ---------------------------------------------------------------------------
# Decode stages (module docstring)
# ---------------------------------------------------------------------------

_DEFAULT: SpanRecorder = NullRecorder()


def default_recorder() -> SpanRecorder:
    """The process-wide default recorder the decode stages write to: a
    ``NullRecorder`` until something calls ``set_default_recorder``."""
    return _DEFAULT


def set_default_recorder(rec: Optional[SpanRecorder]) -> SpanRecorder:
    """Install ``rec`` as the process default (None -> NullRecorder);
    returns the previous default so callers can restore it."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = rec if rec is not None else NullRecorder()
    return prev


_ZERO = {"device_s": 0.0, "steps": 0, "circulations": 0, "host_syncs": 0}
_TOTALS: Dict[str, Dict[str, float]] = {}
_OPEN: List["_Stage"] = []  # active stages, innermost last
# (totals entry, span, entry event, exit event) awaiting the device
_PENDING: "collections.deque" = collections.deque()


class _Stage:
    """An active stage: the profiler range, the recorder's span, the
    timing events and the totals."""

    __slots__ = ("name", "device", "attrs", "span", "range", "start", "syncs")

    def __init__(self, name: str, device, attrs: dict):
        self.name = name
        self.device = device if device is not None and device.type == "cuda" else None
        self.attrs = attrs
        self.range = None
        self.start = None
        self.syncs = 0

    def __enter__(self):
        full = "repro_torch." + self.name
        if _autograd_profiler._is_profiler_enabled:
            # private API (torch 2.11 to 2.13 have it); a test in
            # tests/test_torch_obs_stages.py fails on a torch without it
            self.range = torch._C._profiler._RecordFunctionFast(full)
            self.range.__enter__()
        self.span = _DEFAULT.start(full, **self.attrs)
        if self.device is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        _OPEN.append(self)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        while _OPEN and _OPEN.pop() is not self:
            pass
        total = _TOTALS.get(self.name)
        if total is None:
            total = _TOTALS[self.name] = dict(_ZERO)
        total["steps"] += self.attrs.get("steps", 0)
        total["circulations"] += self.attrs.get("circulations", 0)
        total["host_syncs"] += self.syncs
        real = self.span is not _NULL_SPAN
        if real:
            if self.syncs:
                self.span.attrs["host_syncs"] = self.syncs
            if exc_type is not None:
                self.span.attrs["error"] = repr(exc)
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            _PENDING.append((total, self.span if real else None, self.start, end))
        _DEFAULT.end(self.span)
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _settle(block=False)
        return False


def stage(name: str, device=None, **attrs):
    """``with stage("traceback", device=phis.device, steps=T):`` — one
    decode stage (module docstring); the shared no-op span when neither
    a profiler session nor an enabled default recorder is there.
    ``device`` (a ``torch.device``, or None) is where the stage's work
    runs: a CUDA device gets the stage's ``device_s``."""
    if not (_autograd_profiler._is_profiler_enabled or _DEFAULT.enabled):
        return _NULL_SPAN
    return _Stage(name, device, attrs)


def host_read(x):
    """``x.item()``: the blocking device-to-host read of a one-element
    tensor (a numpy scalar reads the same way), counted in the innermost
    open stage's ``host_syncs`` when ``x`` is a tensor."""
    if _OPEN and isinstance(x, torch.Tensor):
        _OPEN[-1].syncs += 1
    return x.item()


def host_upload(x, device) -> torch.Tensor:
    """``torch.as_tensor(x, device=device)``: a copy of host data onto
    ``device``, which from pageable memory waits for the card's stream to
    drain, counted in the innermost open stage's ``host_syncs``."""
    if _OPEN:
        _OPEN[-1].syncs += 1
    return torch.as_tensor(x, device=device)


def _settle(block: bool) -> None:
    """Turn the timing events the device has passed (all of them with
    ``block``, waiting for the device) into ``device_s``."""
    while _PENDING:
        total, span, start, end = _PENDING[0]
        if block:
            end.synchronize()
        elif not end.query():
            return
        device_s = start.elapsed_time(end) * 1e-3
        total["device_s"] += device_s
        if span is not None:
            span.attrs["device_s"] = device_s
        _PENDING.popleft()


def stage_totals() -> Dict[str, Dict[str, float]]:
    """Per-stage totals since the last ``reset_stage_totals``: ``{name:
    {device_s, steps, circulations, host_syncs}}``.  Waits for the device
    to pass every stage already closed, so ``device_s`` is complete."""
    _settle(block=True)
    return {name: dict(total) for name, total in _TOTALS.items()}


def reset_stage_totals() -> None:
    """Empty the totals (and forget device times still pending)."""
    _TOTALS.clear()
    _PENDING.clear()
