"""Reading ``torch.profiler``'s trace of the traced calls.

The harness profiles a stretch of consecutive calls inside the window
(CPU and CUDA activity) and marks it with the range ``portbench.window``,
each call with ``portbench.call``.  From the trace this module takes:

- the device intervals: every kernel, copy and fill that ran on the card
  (the ranges' own images on the device timeline are left out);
- ``busy_s``: the length of their union inside the traced window, and
  ``window_s``, the window's length;
- ``kernels`` and ``kernel_s``: the kernels that started in the window
  and the sum of their times;
- the device operations that took most time, by name;
- the idle gaps (the window less the union), each labelled by the
  innermost host operation that was running at its midpoint on the
  harness's thread, summed by label.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

__all__ = ["TraceSummary", "merge", "gaps", "innermost", "summarize", "TOP"]

WINDOW, CALL = "portbench.window", "portbench.call"
TOP = 10  # entries of each breakdown list


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    kernel_s: float
    calls: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted union of [start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(merged: Sequence[Tuple[float, float]], lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in merged if e > lo and s < hi]


def gaps(merged: Sequence[Tuple[float, float]], lo: float, hi: float):
    """[lo, hi) less the disjoint sorted intervals ``merged``."""
    out, t = [], lo
    for s, e in clip(merged, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(spans: Sequence[Tuple[float, float, str]], points: Sequence[float]) -> List[Optional[str]]:
    """The name of the innermost span covering each point (None where no
    span does).  Spans are properly nested, as one thread's are."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    labels: List[Optional[str]] = [None] * len(points)
    stack: list = []
    j = 0
    for i in order:
        p = points[i]
        while j < len(spans) and spans[j][0] <= p:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        labels[i] = stack[-1][2] if stack else None
    return labels


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def summarize(events, calls: int) -> Optional[TraceSummary]:
    """The summary of a profiler's ``events()`` (None where the trace holds
    no traced window or no device operation in it)."""
    from torch.autograd import DeviceType

    windows = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not windows:
        return None
    win = windows[0]
    lo, hi = win.time_range.start, win.time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith("portbench.")
              and e.time_range.end > lo and e.time_range.start < hi]
    if not device:
        return None
    merged = merge([(e.time_range.start, e.time_range.end) for e in device])
    busy = sum(e - s for s, e in clip(merged, lo, hi))
    kernels = [e for e in device if not _is_copy(e.name) and e.time_range.start >= lo]
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.thread == win.thread]
    idle = gaps(merged, lo, hi)
    labels = innermost(host, [(s + e) / 2 for s, e in idle])
    by_label: dict = {}
    for (s, e), label in zip(idle, labels):
        key = label or "(no host operation)"
        by_label[key] = by_label.get(key, 0.0) + (e - s)
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy * 1e-6,
        kernels=len(kernels),
        kernel_s=sum(e.time_range.elapsed_us() for e in kernels) * 1e-6,
        calls=calls,
        device_ops=_top_seconds(by_name),
        idle_gaps=_top_seconds(by_label),
    )


def _top_seconds(us_by_name: dict) -> list:
    """The ``TOP`` largest entries, as [name, seconds]."""
    ranked = sorted(us_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, us * 1e-6] for name, us in ranked]

