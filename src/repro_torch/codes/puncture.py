"""Puncturing / rate matching.

Every deployed standard derives its high-rate codes from a low-rate
mother code by *puncturing*: the transmitter deletes coded bits on a
periodic pattern, the receiver re-inserts **zero-LLR erasures** at the
deleted positions.  A zero LLR contributes nothing to any branch metric
(the +-1 correlation multiplies it by +-1), so the depunctured stream
flows through the fused-matmul ACS and the CUDA kernels (K1, K2, K3)
with no kernel change.

``puncture`` and ``depuncture`` are one gather and one scatter by an
index vector derived from the pattern and the stage count
(``kept_indices``, an lru-cached numpy map), moved to each device once.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

__all__ = ["PuncturePattern", "identity_pattern", "puncture", "depuncture"]


@dataclasses.dataclass(frozen=True)
class PuncturePattern:
    """A periodic keep/delete mask over coded stages.

    ``mask[p][b]`` is 1 to transmit output bit b of stage ``t`` with
    t ≡ p (mod period), 0 to puncture it.  Rows are stages (the
    standard's puncturing matrix transposed): e.g. the 802.11a rate-3/4
    pattern [[1,1],[1,0],[0,1]] keeps A0 B0 A1 B2 out of every 3 stages.
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
        """Mother-code bits per kept bit (>= 1): how much longer survivor
        merge and overlap windows must be, in stages, to carry the same
        information as the unpunctured code."""
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
        return int(self._tiled_mask(n).sum())

    def stages_for(self, n_punct: int) -> int:
        """Smallest stage count whose punctured length is ``n_punct``."""
        full, rem = divmod(n_punct, self.n_kept)
        n = full * self.period
        flat = np.asarray(self.mask, dtype=np.int64).reshape(-1)
        while rem > 0:
            take = int(flat[(n % self.period) * self.beta:
                            (n % self.period + 1) * self.beta].sum())
            rem -= take
            n += 1
        if rem != 0:
            raise ValueError(
                f"punctured length {n_punct} does not align with pattern "
                f"(period={self.period}, kept/period={self.n_kept})"
            )
        return n

    def _tiled_mask(self, n: int) -> np.ndarray:
        reps = -(-n // self.period)
        tiled = np.tile(np.asarray(self.mask, dtype=bool), (reps, 1))
        return tiled[:n]

    @functools.lru_cache(maxsize=64)
    def kept_indices(self, n: int) -> np.ndarray:
        """Flat indices (into the (n, beta) stage-major layout) of the
        kept bits: the gather/scatter map."""
        return np.flatnonzero(self._tiled_mask(n).reshape(-1))


@functools.lru_cache(maxsize=64)
def _kept_index(pattern: PuncturePattern, n: int, device: torch.device):
    """``kept_indices(n)`` as an int64 tensor on ``device``, made once."""
    return torch.as_tensor(pattern.kept_indices(n), device=device)


def identity_pattern(beta: int) -> PuncturePattern:
    """The pattern that keeps every bit (rate = the mother code's)."""
    return PuncturePattern(mask=((1,) * beta,))


def puncture(coded, pattern: PuncturePattern) -> torch.Tensor:
    """(..., n, beta) coded bits or symbols -> (..., Lp) kept serial
    stream, on the input's device."""
    coded = torch.as_tensor(coded)
    n, beta = coded.shape[-2], coded.shape[-1]
    if beta != pattern.beta:
        raise ValueError(f"pattern beta={pattern.beta}, input beta={beta}")
    idx = _kept_index(pattern, n, coded.device)
    flat = coded.reshape(coded.shape[:-2] + (n * beta,))
    return flat.index_select(-1, idx)


def depuncture(kept, pattern: PuncturePattern, n: int = None) -> torch.Tensor:
    """(..., Lp) kept LLRs -> (..., n, beta) with zero-LLR erasures, on
    the input's device.

    ``n`` (stage count) defaults to the smallest stage count consistent
    with Lp; pass it explicitly when trailing stages are fully punctured.
    """
    kept = torch.as_tensor(kept)
    lp = kept.shape[-1]
    if n is None:
        n = pattern.stages_for(lp)
    idx = _kept_index(pattern, n, kept.device)
    if idx.shape[0] != lp:
        raise ValueError(
            f"punctured length {lp} inconsistent with n={n} stages "
            f"(expected {idx.shape[0]})"
        )
    beta = pattern.beta
    flat = kept.new_zeros(kept.shape[:-1] + (n * beta,))
    flat.index_copy_(-1, idx, kept)
    return flat.reshape(kept.shape[:-1] + (n, beta))
