"""Per-cell metrics registry: counters, gauges, fixed-bucket histograms.

A pure-Python copy of the reference's ``obs/metrics.py``, kept in the
port so that it imports nothing of the JAX package.

Every value is a (metric family, label set) pair.  Families hold plain
dict-of-floats state keyed by the canonicalized label tuple, so
recording is one dict lookup + add, and the no-op twins below make the
library-wide default free (``NullRegistry`` is what
``default_registry()`` returns until something installs a real one).
The decoder's ``decoder_dispatch_total{path}`` counter and the input
validation counters write here.

Histograms use FIXED power-of-two buckets (``POW2_BUCKETS``).  Each
histogram also keeps a bounded exact-value window (``window`` most
recent observations) so quantile queries over the recent window are
exact, while the bucket counts serve Prometheus and long-horizon
aggregation.

Exports:

  * ``MetricsRegistry.render_prometheus()`` — Prometheus text
    exposition format (text/plain; version 0.0.4).
  * ``MetricsRegistry.snapshot()`` — one plain-dict snapshot (JSON-able).

Label values are bounded enums (codes, decode paths, events), never
request ids or timestamps.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

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

# fixed histogram bucket upper bounds: 2^-20 s (~1 us) .. 2^6 s, one
# bucket per octave, shared by every histogram so feeds aggregate in one
# schema
POW2_BUCKETS: Tuple[float, ...] = tuple(
    float(2.0 ** e) for e in range(-20, 7)
)


def _canon(labels: dict) -> Tuple[Tuple[str, str], ...]:
    """Canonical hashable label key: sorted (name, str(value)) pairs."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _matches(key: Tuple[Tuple[str, str], ...], flt: dict) -> bool:
    if not flt:
        return True
    d = dict(key)
    return all(d.get(k) == str(v) for k, v in flt.items())


class _Family:
    """Shared storage/selection machinery of one named metric family."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def _keys(self, flt: dict):
        return [k for k in self._values if _matches(k, flt)]

    def value(self, **labels) -> float:
        """Exact value of one label set (0.0 if never touched)."""
        return self._values.get(_canon(labels), 0.0)

    def total(self, **label_filter) -> float:
        """Sum across every label set matching the filter."""
        return sum(self._values[k] for k in self._keys(label_filter))

    def series(self) -> List[Tuple[dict, float]]:
        return [(dict(k), v) for k, v in sorted(self._values.items())]


class Counter(_Family):
    """Monotonic counter family; ``inc`` never goes negative."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        k = _canon(labels)
        self._values[k] = self._values.get(k, 0.0) + n


class Gauge(_Family):
    """Point-in-time value family (queue depth, occupancy, ...)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        self._values[_canon(labels)] = float(v)

    def add(self, n: float, **labels) -> None:
        k = _canon(labels)
        self._values[k] = self._values.get(k, 0.0) + n


class _HistState:
    __slots__ = ("counts", "sum", "n", "window")

    def __init__(self, n_buckets: int, window: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.n = 0
        self.window: Optional[List[float]] = [] if window else None


class Histogram(_Family):
    """Fixed-bucket histogram family (POW2_BUCKETS by default) with an
    optional bounded exact-value window for exact recent quantiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = POW2_BUCKETS,
                 window: int = 0):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        self.window = int(window)
        self._states: Dict[Tuple[Tuple[str, str], ...], _HistState] = {}

    def _state(self, labels: dict) -> _HistState:
        k = _canon(labels)
        st = self._states.get(k)
        if st is None:
            st = self._states[k] = _HistState(len(self.buckets), self.window)
            self._values[k] = 0.0  # participate in _keys()/series()
        return st

    def observe(self, v: float, **labels) -> None:
        st = self._state(labels)
        i = 0
        for i, ub in enumerate(self.buckets):  # noqa: B007 (27 buckets)
            if v <= ub:
                break
        else:
            i = len(self.buckets)
        st.counts[i] += 1
        st.sum += v
        st.n += 1
        self._values[_canon(labels)] = float(st.n)
        if st.window is not None:
            st.window.append(v)
            if len(st.window) > self.window:
                del st.window[: len(st.window) - self.window]

    def count(self, **label_filter) -> int:
        return int(sum(
            self._states[k].n for k in self._keys(label_filter)
        ))

    def sum_(self, **label_filter) -> float:
        return sum(self._states[k].sum for k in self._keys(label_filter))

    def quantile(self, q: float, **label_filter) -> float:
        """q in [0, 1].  Exact over the merged recent windows when the
        histogram keeps windows; bucket upper-bound interpolation
        otherwise (conservative: reports the bucket's upper edge)."""
        keys = self._keys(label_filter)
        if not keys:
            return 0.0
        if self.window:
            merged: List[float] = []
            for k in keys:
                if self._states[k].window:
                    merged.extend(self._states[k].window)
            if merged:
                merged.sort()
                # linear-interpolated quantile, numpy 'linear' semantics
                pos = q * (len(merged) - 1)
                lo = int(math.floor(pos))
                hi = min(lo + 1, len(merged) - 1)
                return merged[lo] + (merged[hi] - merged[lo]) * (pos - lo)
        counts = [0] * (len(self.buckets) + 1)
        for k in keys:
            for i, c in enumerate(self._states[k].counts):
                counts[i] += c
        total = sum(counts)
        if not total:
            return 0.0
        target = q * total
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target and c:
                return (
                    self.buckets[i] if i < len(self.buckets)
                    else self.buckets[-1]
                )
        return self.buckets[-1]

    def state_series(self):
        return [
            (dict(k), self._states[k]) for k in sorted(self._states)
        ]


class MetricsRegistry:
    """Named metric families, one instance per engine/farm/process.

    ``counter``/``gauge``/``histogram`` are get-or-create (stable
    identity per name), so call sites can fetch by name at any
    frequency without allocation.
    """

    enabled = True

    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _get(self, name: str, cls, **kw) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = cls(name, **kw)
        elif not isinstance(fam, cls):
            raise TypeError(
                f"metric {name!r} already registered as {fam.kind}"
            )
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = POW2_BUCKETS,
                  window: int = 0) -> Histogram:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = Histogram(
                name, help=help, buckets=buckets, window=window
            )
        elif not isinstance(fam, Histogram):
            raise TypeError(
                f"metric {name!r} already registered as {fam.kind}"
            )
        return fam

    def families(self) -> Iterable[_Family]:
        return [self._families[n] for n in sorted(self._families)]

    # -- exporters ---------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict snapshot of every family (JSON-able)."""
        out: dict = {}
        for fam in self.families():
            if isinstance(fam, Histogram):
                out[fam.name] = {
                    "kind": fam.kind,
                    "series": [
                        {
                            "labels": lbl,
                            "count": st.n,
                            "sum": st.sum,
                            "buckets": list(st.counts),
                        }
                        for lbl, st in fam.state_series()
                    ],
                    "bucket_bounds": list(fam.buckets),
                }
            else:
                out[fam.name] = {
                    "kind": fam.kind,
                    "series": [
                        {"labels": lbl, "value": v}
                        for lbl, v in fam.series()
                    ],
                }
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if isinstance(fam, Histogram):
                for lbl, st in fam.state_series():
                    acc = 0
                    for i, ub in enumerate(fam.buckets):
                        acc += st.counts[i]
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_prom_labels(lbl, le=_prom_f(ub))} {acc}"
                        )
                    acc += st.counts[-1]
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_prom_labels(lbl, le='+Inf')} {acc}"
                    )
                    lines.append(
                        f"{fam.name}_sum{_prom_labels(lbl)} {st.sum:.9g}"
                    )
                    lines.append(
                        f"{fam.name}_count{_prom_labels(lbl)} {st.n}"
                    )
            else:
                for lbl, v in fam.series():
                    lines.append(f"{fam.name}{_prom_labels(lbl)} {v:.9g}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_f(v: float) -> str:
    return f"{v:.9g}"


def _prom_labels(labels: dict, **extra) -> str:
    items = {**labels, **extra}
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape(str(v))}"' for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


# -- the zero-cost disabled twins -------------------------------------------

class _NullFamily:
    """Absorbs every record/query; shared singletons below."""

    kind = "null"
    name = "null"
    help = ""
    buckets: Tuple[float, ...] = POW2_BUCKETS

    def inc(self, n: float = 1, **labels) -> None:
        pass

    def set(self, v: float, **labels) -> None:
        pass

    def add(self, n: float, **labels) -> None:
        pass

    def observe(self, v: float, **labels) -> None:
        pass

    def value(self, **labels) -> float:
        return 0.0

    def total(self, **label_filter) -> float:
        return 0.0

    def count(self, **label_filter) -> int:
        return 0

    def sum_(self, **label_filter) -> float:
        return 0.0

    def quantile(self, q: float, **label_filter) -> float:
        return 0.0

    def series(self):
        return []

    def state_series(self):
        return []


_NULL_FAMILY = _NullFamily()


class NullRegistry(MetricsRegistry):
    """The default registry: every family is the shared no-op singleton,
    so instrumented library code (decoder path counters, farm spans)
    costs one attribute call when observability is off."""

    enabled = False

    def counter(self, name: str, help: str = ""):  # type: ignore[override]
        return _NULL_FAMILY

    def gauge(self, name: str, help: str = ""):  # type: ignore[override]
        return _NULL_FAMILY

    def histogram(self, name: str, help: str = "",  # type: ignore[override]
                  buckets: Tuple[float, ...] = POW2_BUCKETS,
                  window: int = 0):
        return _NULL_FAMILY

    def families(self):
        return []


_DEFAULT: MetricsRegistry = NullRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide default registry library instrumentation writes
    to (``core.decoder`` path counters).  A ``NullRegistry`` until
    something calls ``set_default_registry`` — zero-cost by default."""
    return _DEFAULT


def set_default_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install ``reg`` as the process default (None -> NullRegistry);
    returns the previous default so callers can restore it."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = reg if reg is not None else NullRegistry()
    return prev
