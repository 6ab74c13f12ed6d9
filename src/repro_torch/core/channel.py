"""BPSK + AWGN channel and LLR formation (paper §IX-B, Fig. 12).

The convention is the reference's: bit 0 -> +1.0, bit 1 -> -1.0, and a
positive LLR means bit 0 is the more likely.  Noise comes from an
explicit ``torch.Generator`` on the symbols' device, so a run is
reproducible from its seed (it will not draw the numbers ``jax.random``
would draw from the same seed, and a CPU generator and a CUDA generator
draw different numbers from one seed).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bpsk", "awgn_sigma", "awgn", "llr", "hard_decision", "derive_seed"]


def bpsk(bits) -> torch.Tensor:
    """Map bit 0 -> +1.0, bit 1 -> -1.0 (Eq. 2's (-1)^alpha)."""
    return 1.0 - 2.0 * torch.as_tensor(bits).to(torch.float32)


def awgn_sigma(ebn0_db: float, rate: float) -> float:
    """Noise standard deviation for unit-energy BPSK at the given Eb/N0."""
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    return float(np.sqrt(1.0 / (2.0 * rate * ebn0)))


def awgn(
    generator: torch.Generator, symbols: torch.Tensor, ebn0_db: float, rate: float
) -> torch.Tensor:
    """``symbols`` plus white Gaussian noise drawn from ``generator``,
    which must live on the symbols' device."""
    sigma = awgn_sigma(ebn0_db, rate)
    noise = torch.randn(
        symbols.shape, generator=generator,
        device=symbols.device, dtype=symbols.dtype,
    )
    return symbols + sigma * noise


def llr(received: torch.Tensor, ebn0_db: float, rate: float) -> torch.Tensor:
    """Soft-decision LLR 2y/sigma^2 (positive => bit 0), paper §II-C."""
    sigma = awgn_sigma(ebn0_db, rate)
    return 2.0 * received / (sigma * sigma)


def hard_decision(received: torch.Tensor) -> torch.Tensor:
    """Hard-decision front end: +-1 from the sign (paper §II-C)."""
    received = torch.as_tensor(received)
    return torch.where(received >= 0, 1.0, -1.0).to(torch.float32)


def derive_seed(*entropy: int) -> int:
    """A 63-bit ``torch.Generator`` seed from non-negative integers
    through ``numpy.random.SeedSequence``: distinct tuples give
    independent streams, and the value is the same in every process
    (unlike ``hash``)."""
    hi, lo = np.random.SeedSequence(list(entropy)).generate_state(2)
    return int(hi) << 31 | int(lo) >> 1
