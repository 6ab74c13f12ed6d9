"""Failure detection and re-planning for the serving runtime, a copy of
the reference's ``runtime/failure.py`` (pure Python, no tensors):

  * ``HeartbeatMonitor`` — hosts post (host_id, time); hosts silent for
    more than ``timeout`` are declared failed;
  * ``ElasticPlanner`` / ``MeshPlan`` — the largest (data, model) mesh
    the survivors can form, the data axis a power of two;
  * ``RetryPolicy`` — bounded exponential backoff for dispatch retries;
  * ``QuarantineRecord`` — the evidence of one confirmed silent data
    corruption, kept by the serving engine;
  * ``StragglerMonitor`` — hosts persistently slower than k x the median
    step time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

__all__ = [
    "HeartbeatMonitor",
    "ElasticPlanner",
    "MeshPlan",
    "StragglerMonitor",
    "RetryPolicy",
    "QuarantineRecord",
]


class HeartbeatMonitor:
    """Declares hosts silent for > ``timeout`` failed.

    ``now`` is the construction-time clock reading: every host starts
    with ``last_seen = now`` (a host is given one full timeout window to
    post its first beat).  The pre-§13 default of 0.0 was a cold-start
    bug — on a wall clock, every host was ``timeout`` seconds "silent"
    at construction and declared failed before it could ever beat.
    """

    def __init__(
        self, hosts: Sequence[int], timeout: float = 30.0, now: float = 0.0
    ):
        self.timeout = timeout
        self.last_seen: Dict[int, float] = {h: float(now) for h in hosts}

    def beat(self, host: int, now: float):
        self.last_seen[host] = now

    def failed(self, now: float) -> List[int]:
        return sorted(
            h for h, t in self.last_seen.items() if now - t > self.timeout
        )

    def alive(self, now: float) -> List[int]:
        return sorted(
            h for h, t in self.last_seen.items() if now - t <= self.timeout
        )


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    hosts: tuple  # host ids in mesh order
    dropped: tuple  # healthy hosts left out (not a power-of-two fit)

    @property
    def size(self) -> int:
        return self.data * self.model


class ElasticPlanner:
    """Re-plan the (data, model) mesh after failures.

    Keeps the model axis if possible (so TP shards stay host-local and the
    reshard is a pure data-axis regroup), shrinking the data axis to the
    largest size that divides the survivor count; otherwise falls back to
    the largest power-of-two mesh.
    """

    def __init__(self, model_axis: int):
        self.model_axis = model_axis

    def plan(self, alive_hosts: Sequence[int]) -> Optional[MeshPlan]:
        alive = sorted(alive_hosts)
        n = len(alive)
        if n == 0:
            return None
        m = self.model_axis
        while m > 1 and n < m:
            m //= 2
        data = n // m
        if data >= 1:
            # keep batch-math friendly: round data axis down to a power of 2
            data = 2 ** int(math.log2(data))
            used = alive[: data * m]
            return MeshPlan(
                data=data,
                model=m,
                hosts=tuple(used),
                dropped=tuple(alive[data * m :]),
            )
        return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for dispatch retries (DESIGN.md §13).

    ``max_retries`` bounds attempts PER LADDER RUNG (each degradation
    step gets a fresh budget); ``backoff(i)`` is the delay before retry
    ``i`` (0-indexed), capped at ``backoff_cap``.  The serving engine
    runs on a virtual clock, so backoff is ACCOUNTED (the
    ``engine_backoff_seconds_total`` counter) rather than slept —
    wall-clock deployments can sleep the same numbers.
    """

    max_retries: int = 3
    backoff_base: float = 0.05
    backoff_cap: float = 2.0

    def backoff(self, attempt: int) -> float:
        return min(self.backoff_cap, self.backoff_base * (2.0 ** attempt))


@dataclasses.dataclass(frozen=True)
class QuarantineRecord:
    """One confirmed-SDC quarantine (DESIGN.md §14).

    A device failure is self-announcing; a silently corrupting device
    is only ever *inferred* — by the serving engine's online scrubber
    (syndrome flag confirmed by shadow re-decode).  The engine appends
    one record per quarantined device to ``engine.quarantine_log`` and
    then routes the device through the same ``replan_mesh`` failover a
    hard failure takes.  The record keeps the evidence: which cell,
    which decode path, and how many of its frames were confirmed
    corrupt — the post-mortem trail a fleet operator pulls before
    re-admitting the device.
    """

    device: int
    at: float  # engine-clock time of the quarantine
    code: str
    path: str
    frames_confirmed: int


class StragglerMonitor:
    """Flags hosts persistently slower than ``k`` x median step time."""

    def __init__(self, k: float = 1.5, patience: int = 3, window: int = 20):
        self.k = k
        self.patience = patience
        self.window = window
        self.times: Dict[int, List[float]] = {}
        self.strikes: Dict[int, int] = {}

    def record_step(self, step_times: Dict[int, float]):
        med = sorted(step_times.values())[len(step_times) // 2]
        for h, t in step_times.items():
            self.times.setdefault(h, []).append(t)
            self.times[h] = self.times[h][-self.window :]
            if t > self.k * med:
                self.strikes[h] = self.strikes.get(h, 0) + 1
            else:
                self.strikes[h] = 0

    def stragglers(self) -> List[int]:
        return sorted(
            h for h, s in self.strikes.items() if s >= self.patience
        )
