"""Semiring of the fused ACS recurrence (paper §V; the reference's
``core/semiring.py``).

Only ``TROPICAL`` (max-plus: hard-decision Viterbi) is ported.
``LOGPROB`` (log-sum-exp, the BCJR alpha recursion) comes with the
soft-output slice, together with the LOGPROB variants of K1 and K3;
asking for it raises ``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .backend import resolve_device

__all__ = ["NEG", "Semiring", "TROPICAL", "check_semiring", "COMPOSE_TEMP_BYTES"]

# the off-trellis score: a finite stand-in for -inf that keeps the
# arithmetic NaN-free (the reference's value, as an f32)
NEG = -1.0e9

# cap on the broadcast temporary of one ``Semiring.matmul`` chunk: the
# reference materialises (batch, n, k, m) at once, which at a long
# time-parallel stream is gigabytes
COMPOSE_TEMP_BYTES = 256 * 2**20


def check_semiring(name: str) -> None:
    """Raise unless ``name`` is a semiring the port implements."""
    if name == "logprob":
        raise NotImplementedError(
            "the LOGPROB semiring (and the logsumexp variants of K1 and K3) "
            "belongs to the soft-output slice of the port"
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

    def matmul(
        self,
        a: torch.Tensor,
        b: torch.Tensor,
        matmul_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """Semiring compose  C[..., i, j] = sum_k A[..., i, k] * B[..., k, j].

        Operands are quantised to ``matmul_dtype`` and the sums taken in
        f32, as in the reference.  The batch is worked through in chunks
        whose (chunk, n, k, m) temporary stays under ``COMPOSE_TEMP_BYTES``;
        every output is a max over exact elementwise sums, so the chunking
        leaves the bits unchanged.
        """
        a = a.to(matmul_dtype).to(torch.float32)
        b = b.to(matmul_dtype).to(torch.float32)
        n, k, m = a.shape[-2], a.shape[-1], b.shape[-1]
        batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        a = a.expand(*batch, n, k).reshape(math.prod(batch), n, k)
        b = b.expand(*batch, k, m).reshape(math.prod(batch), k, m)
        out = torch.empty(
            (a.shape[0], n, m), dtype=torch.float32, device=a.device
        )
        step = max(1, COMPOSE_TEMP_BYTES // max(1, n * k * m * 4))
        for lo in range(0, a.shape[0], step):
            hi = lo + step
            out[lo:hi] = self.sum(
                a[lo:hi, :, :, None] + b[lo:hi, None, :, :], dim=-2
            )
        return out.reshape(*batch, n, m)

    def identity(self, n: int, device=None) -> torch.Tensor:
        """The (n, n) unit matrix: 0 on the diagonal, ``NEG`` off it, on
        ``device`` (None is the card)."""
        device = resolve_device(device)
        eye = torch.eye(n, dtype=torch.bool, device=device)
        return torch.where(
            eye,
            torch.tensor(0.0, device=device),
            torch.tensor(NEG, device=device),
        )


TROPICAL = Semiring("tropical")
