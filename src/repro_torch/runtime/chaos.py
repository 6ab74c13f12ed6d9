"""Deterministic fault injection for the serving engine, a copy of the
reference's ``runtime/chaos.py`` (numpy only).

A ``ChaosSchedule`` is a list of one-shot ``FaultEvent``s indexed by
dispatch attempt: the engine numbers every dispatch it makes (batch
cells, session groups, retries and degraded re-dispatches all count),
and the ``ChaosInjector`` fires the events whose ``at`` is the current
attempt.  Cells and sessions run in sorted order on a virtual clock, so
the same schedule against the same traffic injects the same faults at
the same dispatches on every run, on the CPU or on the card.

Fault kinds:

  * ``device_failure`` — raised as ``DeviceFailure(device=i)``; the
    engine drops the device, re-plans the mesh
    (``distributed.decoder.replan_mesh``) and retries, degrading
    sharded -> batch when too few devices remain;
  * ``timeout`` — raised as ``DispatchTimeout``; retried with backoff;
  * ``slow`` — a straggler: ``on_dispatch`` returns a delay, which the
    engine promotes to a timeout at or past its ``dispatch_timeout``;
  * ``compile_error`` — a transient build failure, raised as
    ``TransientCompileError`` and retried;
  * ``bit_flip`` — silent data corruption: nothing is raised;
    ``on_dispatch`` arms the event and the engine's ``corrupt(bits)``
    call after the dispatch flips ``flips`` seeded positions of the
    decoded bits.  Only the scrubber (``verify.scrub``) can see it.

Schedules are hand-written or drawn from ``np.random.default_rng(seed)``
(``ChaosSchedule.generate``), and round-trip through the reference's
JSON format, so one file drives both packages' engines.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import pathlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "InjectedFault",
    "DeviceFailure",
    "DispatchTimeout",
    "TransientCompileError",
    "FaultEvent",
    "ChaosSchedule",
    "ChaosInjector",
    "FAULT_KINDS",
]

FAULT_KINDS = (
    "device_failure", "timeout", "slow", "compile_error", "bit_flip",
)


class InjectedFault(RuntimeError):
    """Base of all injected dispatch faults; ``kind`` names the family
    (the engine's ``engine_faults_total`` label)."""

    kind = "fault"


class DeviceFailure(InjectedFault):
    """A device dropped out of the mesh mid-dispatch."""

    kind = "device_failure"

    def __init__(self, device: Optional[int] = None):
        super().__init__(f"device {device} failed")
        self.device = device


class DispatchTimeout(InjectedFault):
    """The dispatch exceeded its deadline (injected, or a promoted
    straggler delay)."""

    kind = "timeout"


class TransientCompileError(InjectedFault):
    """A transient build failure (retryable by definition)."""

    kind = "compile_error"


_EXC = {
    "device_failure": DeviceFailure,
    "timeout": DispatchTimeout,
    "compile_error": TransientCompileError,
}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires at dispatch attempt ``at`` (one-shot).

    ``path`` restricts the event to dispatches on that decode path
    (None = any path); an event whose attempt index passes with a
    non-matching path is skipped, not deferred — schedules stay
    attempt-indexed and deterministic.  ``device`` names the failing
    device for ``device_failure`` (and the silently corrupting device
    for ``bit_flip`` — the scrubber's quarantine target); ``delay`` is
    the straggler delay in seconds for ``slow``; ``flips`` is the
    number of output bits a ``bit_flip`` event corrupts.
    """

    at: int
    kind: str
    device: Optional[int] = None
    delay: float = 0.0
    path: Optional[str] = None
    flips: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
            )


class ChaosSchedule:
    """An immutable, attempt-indexed list of ``FaultEvent``s."""

    def __init__(self, events: Iterable[FaultEvent]):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.at, e.kind))
        )

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = collections.Counter(e.kind for e in self.events)
        return dict(c)

    # -- (de)serialization -------------------------------------------------

    def to_json(self) -> dict:
        events = []
        for e in self.events:
            d = {"at": e.at, "kind": e.kind}
            if e.device is not None:
                d["device"] = e.device
            if e.delay:
                d["delay"] = e.delay
            if e.path is not None:
                d["path"] = e.path
            if e.flips != 1:
                d["flips"] = e.flips
            events.append(d)
        return {"events": events}

    @classmethod
    def from_json(cls, obj) -> "ChaosSchedule":
        if isinstance(obj, str):
            obj = json.loads(obj)
        events = obj["events"] if isinstance(obj, dict) else obj
        return cls(FaultEvent(**e) for e in events)

    @classmethod
    def from_file(cls, path) -> "ChaosSchedule":
        return cls.from_json(pathlib.Path(path).read_text())

    # -- seeded generation -------------------------------------------------

    @classmethod
    def generate(
        cls,
        seed: int,
        n_attempts: int,
        p_device: float = 0.02,
        p_timeout: float = 0.02,
        p_slow: float = 0.02,
        p_compile: float = 0.01,
        n_devices: int = 1,
        slow_delay: float = 0.05,
        p_bit_flip: float = 0.0,
        max_flips: int = 1,
    ) -> "ChaosSchedule":
        """Draw a schedule from a seeded RNG: each attempt index
        independently hosts at most one fault, with the given per-kind
        probabilities.  Same seed -> same schedule, always."""
        rng = np.random.default_rng(seed)
        probs = (p_device, p_timeout, p_slow, p_compile, p_bit_flip)
        edges = np.cumsum(probs)
        if edges[-1] > 1.0:
            raise ValueError(f"fault probabilities sum to {edges[-1]} > 1")
        events: List[FaultEvent] = []
        for at in range(n_attempts):
            u = rng.random()
            if u >= edges[-1]:
                continue
            kind = FAULT_KINDS[int(np.searchsorted(edges, u, side="right"))]
            events.append(FaultEvent(
                at=at,
                kind=kind,
                device=(int(rng.integers(0, n_devices))
                        if kind in ("device_failure", "bit_flip") else None),
                delay=float(slow_delay) if kind == "slow" else 0.0,
                flips=(int(rng.integers(1, max_flips + 1))
                       if kind == "bit_flip" else 1),
            ))
        return cls(events)


class ChaosInjector:
    """Fires a ``ChaosSchedule`` against a stream of engine dispatches.

    The engine calls ``on_dispatch(code, path)`` immediately before
    every dispatch (including retries and degraded re-dispatches); the
    call increments the attempt counter, raises the typed exception for
    any matching raising event, and returns the summed straggler delay
    of matching ``slow`` events (0.0 when none).  ``injected`` counts
    fired events by kind, against which the engine's retry counters are
    checked.
    """

    def __init__(self, schedule: ChaosSchedule):
        self.schedule = schedule
        self._by_at: Dict[int, List[FaultEvent]] = {}
        for e in schedule.events:
            self._by_at.setdefault(e.at, []).append(e)
        self.attempts = 0
        self.injected: Dict[str, int] = collections.Counter()
        self._armed: List[FaultEvent] = []  # pending bit_flip events

    def on_dispatch(self, code: str, path: str) -> float:
        """Advance the attempt counter; raise or return a delay.

        ``bit_flip`` events never raise — the corruption is *silent* by
        definition.  They are armed here and fire when the engine hands
        the dispatch's output to :meth:`corrupt`.
        """
        at = self.attempts
        self.attempts += 1
        delay = 0.0
        for e in self._by_at.get(at, ()):
            if e.path is not None and e.path != path:
                continue
            if e.kind == "bit_flip":
                self._armed.append(e)
                continue
            self.injected[e.kind] += 1
            if e.kind == "slow":
                delay += e.delay
            else:
                raise _EXC[e.kind](e.device) if (
                    e.kind == "device_failure"
                ) else _EXC[e.kind](
                    f"injected {e.kind} at attempt {at} ({code}/{path})"
                )
        return delay

    def corrupt(self, bits: np.ndarray):
        """Apply armed ``bit_flip`` events to a dispatch's decoded bits.

        Returns ``(bits, device)``: a corrupted copy (or the input
        unchanged when nothing is armed) and the device attributed to
        the last fired event (None when clean).  Flip positions are
        drawn from an RNG seeded by the event's attempt index — the
        same schedule corrupts the same positions every run.  Counted
        into ``injected["bit_flip"]`` at fire time, so scrubber
        detection totals can be compared against it exactly.
        """
        if not self._armed:
            return bits, None
        out = np.array(bits, copy=True)
        flat = out.reshape(-1)
        device = None
        for e in self._armed:
            rng = np.random.default_rng(1_000_003 * (e.at + 1) + 17)
            n = min(max(1, e.flips), flat.shape[0])
            idx = rng.choice(flat.shape[0], size=n, replace=False)
            flat[idx] ^= 1
            self.injected["bit_flip"] += 1
            if e.device is not None:
                device = e.device
        self._armed.clear()
        return out, device

    def total_injected(self) -> int:
        return int(sum(self.injected.values()))
