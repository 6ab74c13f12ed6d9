"""Semiring of the fused ACS recurrence (paper §V; the reference's
``core/semiring.py``).

Two instances, as in the reference:

  * ``TROPICAL`` — max-plus: sum = max.  Hard-decision Viterbi, and the
    bit-exact default everywhere;
  * ``LOGPROB`` — log-sum-exp: sum = ``m + log(sum(exp(x - m)))`` with
    ``m = max(x)``, the BCJR forward-backward recursions
    (``core/soft.py``).  It is written out in the reference's form, not
    as ``torch.logsumexp``, so that both packages and the CUDA kernels
    (K1 and K3 at LOGPROB) round the same steps.

Both share the additive identity ``NEG`` (the off-trellis score, a
finite stand-in for -inf whose ``exp(NEG - m)`` is exactly 0) and the
multiplicative identity 0.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .backend import resolve_device

__all__ = [
    "NEG", "Semiring", "TROPICAL", "LOGPROB", "get_semiring",
    "check_semiring", "COMPOSE_TEMP_BYTES",
]

# the off-trellis score: a finite stand-in for -inf that keeps the
# arithmetic NaN-free (the reference's value, as an f32)
NEG = -1.0e9

# cap on the broadcast temporary of one chunk of the plain compose
# (``Semiring.matmul_plain``): the reference materialises (batch, n, k, m)
# at once, which at a long time-parallel stream is gigabytes
COMPOSE_TEMP_BYTES = 256 * 2**20

# the semirings' names, also the kernels' selectors; ``_BY_NAME`` is built from them
_NAMES = ("logprob", "tropical")


def check_semiring(name: str) -> None:
    """Raise ``ValueError`` unless ``name`` is a semiring of the port."""
    if name not in _NAMES:
        raise ValueError(
            f"unknown semiring {name!r}; expected one of {list(_NAMES)}"
        )


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A commutative semiring on log-domain f32 scores; ``prod`` is ``+``,
    so only the reductions (``sum``) differ between the instances."""

    name: str  # "tropical" | "logprob", also the kernel-side selector

    def __post_init__(self):
        check_semiring(self.name)

    @property
    def zero(self) -> float:
        """Additive identity (absorbing for prod): the off-trellis score."""
        return NEG

    @property
    def one(self) -> float:
        """Multiplicative identity: a zero log-score."""
        return 0.0

    def sum(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Semiring sum-reduce along ``dim``: max, or the max-normalised
        logsumexp ``m + log(sum(exp(x - m)))``."""
        m = x.amax(dim=dim)
        if self.name == "tropical":
            return m
        return m + torch.log(torch.exp(x - m.unsqueeze(dim)).sum(dim=dim))

    def prod(self, a, b):
        """Semiring product: log-domain score accumulation."""
        return a + b

    def matmul(
        self,
        a: torch.Tensor,
        b: torch.Tensor,
        matmul_dtype: torch.dtype = torch.float32,
        use_kernel: bool = True,
    ) -> torch.Tensor:
        """Semiring compose  C[..., i, j] = sum_k A[..., i, k] * B[..., k, j].

        Operands are quantised to ``matmul_dtype`` and the sums taken in
        f32, as in the reference.  ``use_kernel`` (default) composes in K4
        (``kernels.viterbi_acs.semiring_compose``: square operands of at
        most 64 states) — the CUDA kernel on the card, its plain version
        on the CPU; ``use_kernel=False`` runs ``matmul_plain`` directly,
        on any device and at any shape.
        """
        if use_kernel:
            from repro_torch.kernels.viterbi_acs import semiring_compose

            return semiring_compose(
                a, b, semiring=self.name, matmul_dtype=matmul_dtype)
        return self.matmul_plain(a, b, matmul_dtype)

    def matmul_plain(
        self,
        a: torch.Tensor,
        b: torch.Tensor,
        matmul_dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        """The plain version of ``matmul`` (K4's, on either device): the
        (batch, n, k, m) sums broadcast and reduced, the batch worked
        through in chunks whose temporary stays under
        ``COMPOSE_TEMP_BYTES``; every output is a reduction over its own
        elementwise sums, which no chunk shares, so the chunking leaves
        every value unchanged.
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


_BY_NAME = {name: Semiring(name) for name in _NAMES}
TROPICAL = _BY_NAME["tropical"]
LOGPROB = _BY_NAME["logprob"]


def get_semiring(name: str) -> Semiring:
    """Resolve a semiring by its kernel-side name."""
    check_semiring(name)
    return _BY_NAME[name]
