"""Puncture patterns (rate matching) as data.

The transmitter deletes coded bits on a periodic pattern and the receiver
re-inserts zero-LLR erasures.  This slice of the port carries the
patterns so the registry can name every standard; depuncturing and
punctured decoding come with the standard-codes slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

__all__ = ["PuncturePattern"]


@dataclasses.dataclass(frozen=True)
class PuncturePattern:
    """A periodic keep/delete mask over coded stages.

    ``mask[p][b]`` is 1 to transmit output bit b of stage ``t`` with
    t ≡ p (mod period), 0 to puncture it.  Rows are stages (the
    standard's puncturing matrix transposed).
    """

    mask: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        mask = tuple(tuple(int(v) for v in row) for row in self.mask)
        object.__setattr__(self, "mask", mask)
        if not mask or not mask[0]:
            raise ValueError("puncture mask must be non-empty")
        beta = len(mask[0])
        if any(len(row) != beta for row in mask):
            raise ValueError("puncture mask rows must have equal length")
        if any(v not in (0, 1) for row in mask for v in row):
            raise ValueError("puncture mask entries must be 0/1")
        if self.n_kept == 0:
            raise ValueError("puncture mask keeps no bits")

    @property
    def period(self) -> int:
        return len(self.mask)

    @property
    def beta(self) -> int:
        return len(self.mask[0])

    @property
    def n_kept(self) -> int:
        """Kept coded bits per period of ``period`` stages."""
        return int(sum(sum(row) for row in self.mask))

    @property
    def expansion(self) -> float:
        """Mother-code bits per kept bit (≥ 1)."""
        return self.period * self.beta / self.n_kept

    def rate(self, mother_beta: int) -> float:
        """Effective code rate: ``period`` message bits emit ``n_kept``
        coded bits (requires the pattern's beta == the code's beta)."""
        if mother_beta != self.beta:
            raise ValueError(
                f"pattern is for beta={self.beta}, code has beta={mother_beta}"
            )
        return self.period / self.n_kept

    def punctured_len(self, n: int) -> int:
        """Number of kept bits for n coded stages (the tiled mask is
        truncated when n is not a multiple of the period)."""
        reps = -(-n // self.period)
        tiled = np.tile(np.asarray(self.mask, dtype=bool), (reps, 1))
        return int(tiled[:n].sum())
