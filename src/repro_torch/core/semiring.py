"""Semiring of the fused ACS recurrence (paper §V; the reference's
``core/semiring.py``).

Only ``TROPICAL`` (max-plus: hard-decision Viterbi) is ported in this
slice.  ``LOGPROB`` (log-sum-exp, the BCJR alpha recursion) comes with
the soft-output slice, together with the LOGPROB variant of the K1
kernel; asking for it raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["NEG", "Semiring", "TROPICAL", "check_semiring"]

# the off-trellis score: a finite stand-in for -inf that keeps the
# arithmetic NaN-free (the reference's value, as an f32)
NEG = -1.0e9


def check_semiring(name: str) -> None:
    """Raise unless ``name`` is a semiring this slice implements."""
    if name == "logprob":
        raise NotImplementedError(
            "the LOGPROB semiring (and K1's logsumexp variant) belongs to "
            "the soft-output slice of the port"
        )
    if name != "tropical":
        raise ValueError(f"unknown semiring {name!r}; expected 'tropical'")


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative semiring on log-domain f32 scores; ``prod`` is ``+``."""

    name: str  # also the kernel-side selector

    def __post_init__(self):
        check_semiring(self.name)

    def sum(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Semiring sum-reduce along ``dim``: max."""
        return x.amax(dim=dim)


TROPICAL = Semiring("tropical")
