"""BPSK + AWGN channel and LLR formation (paper §IX-B, Fig. 12).

The convention is the reference's: bit 0 -> +1.0, bit 1 -> -1.0, and a
positive LLR means bit 0 is the more likely.  Noise comes from an
explicit ``torch.Generator`` on the symbols' device, so a run is
reproducible from its seed (it will not draw the numbers ``jax.random``
would draw from the same seed).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bpsk", "awgn_sigma", "awgn", "llr"]


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
