"""Measured windows: how a traffic mix offers its calls to the program.

A traffic file names its loop (``"loop"``, default ``"closed"``), and the
harness calls ``loops.<loop>.run(step, batches, traffic, seconds, seed,
trace, device, info_bits)``, which returns a ``Window`` and the sampled
``(pool index, output)`` pairs.  A loop that measures something of its
own (an open loop's sojourn times, say) puts it in ``Window.extra``,
which the metrics' readers see as ``RunContext.extra``.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional

import torch

from portbench import generate
from portbench.trace import TraceSummary

__all__ = ["Window", "Reservoir", "sync"]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    calls: int = 0
    ok_calls_bits: int = 0
    attempted: int = 0
    failed: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0
    t_start: float = 0.0
    errors: list = dataclasses.field(default_factory=list)
    trace: Optional[TraceSummary] = None
    extra: dict = dataclasses.field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``size`` call outputs, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.seen, self.items = size, 0, []
        self.rng = random.Random(generate.sub_seed(seed, 1 << 30))

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1
