"""The frozen yardstick of a decode's least time on one H100.

Peaks (NVIDIA H100 SXM5 80 GB at its 700 W limit and 1.98 GHz boost
clock; the card's ``power.limit`` is printed beside every share a run
reports):

- ``F32_OPS``: 132 SMs x 128 float32 lanes x 1.98 GHz = 33.45e12 float32
  instructions a second outside the tensor cores (CUDA C++ Programming
  Guide, arithmetic instruction throughput of compute capability 9.0:
  128 results a clock an SM for a 32-bit add, multiply, multiply-add,
  compare or max).  The data sheet's 67e12 counts a multiply-add as two;
  the decode's work is adds, compares and maxima, one instruction each,
  which the tensor cores do not do.  An operation below is one such
  instruction.
- ``HBM_BYTES``: 3.35e12 bytes a second of device memory (data sheet).
- ``SFU_OPS``: 16 special-function results a clock on each of 132 SMs
  (the same table): the rate of the exponentials of a log-domain step.

The bytes and the special functions copy the program's
``repro_torch.roofline.H100`` and ``chip_smoke.PEAK_SFU_OPS``, and the
count below follows ``chip_smoke.acs_bound`` with one entry row, so that
a later change of the program cannot move the yardstick.

The work counts the decode needs, whatever implements it: each input
LLR read once and each output written once (float32 LLRs, int32 bits or
float32 output LLRs), and one ACS pass per trellis step of every frame
or stream (``acs_step``), the soft decode a forward and a backward
log-domain pass and the LLR combine (``combine_step``).  Overlapping
windows, transfer matrices and tracebacks are ways to do that work and
are not counted.
"""
from __future__ import annotations

import dataclasses

from portbench.reference.conv import Trellis

__all__ = ["F32_OPS", "HBM_BYTES", "SFU_OPS", "Work", "acs_step", "combine_step"]

F32_OPS = 132 * 128 * 1.98e9
HBM_BYTES = 3.35e12
SFU_OPS = 16 * 132 * 1.98e9


@dataclasses.dataclass(frozen=True)
class Work:
    f32_ops: float
    sfu_ops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.f32_ops + other.f32_ops, self.sfu_ops + other.sfu_ops,
                    self.bytes + other.bytes)

    def scaled(self, times: float) -> "Work":
        return Work(self.f32_ops * times, self.sfu_ops * times, self.bytes * times)

    def least_time_s(self) -> float:
        """The larger of the operations' and the bytes' time."""
        return max(self.f32_ops / F32_OPS, self.sfu_ops / SFU_OPS,
                   self.bytes / HBM_BYTES)

    def bound_by(self) -> str:
        t = {"f32 operations": self.f32_ops / F32_OPS,
             "special functions": self.sfu_ops / SFU_OPS,
             "bytes": self.bytes / HBM_BYTES}
        return max(t, key=t.get)


def acs_step(tr: Trellis, semiring: str = "tropical", renorm: bool = True) -> Work:
    """One radix-2^rho ACS step of one frame from one entry row: the
    distinct branch metrics once (one multiply-add per nonzero weight),
    for each state R adds of the predecessor's metric and R - 1 maxima,
    with ``renorm`` the frame max and the subtraction (2S - 1).  At ``"logprob"`` each state also takes R - 1 exponentials
    and 2R operations: R - 1 differences, R - 1 adds, the logarithm
    counted as one, and the final add."""
    S, R = tr.S, tr.R
    ops = int((tr.cols != 0).sum()) + S * (2 * R - 1) + ((2 * S - 1) if renorm else 0)
    sfu = 0
    if semiring == "logprob":
        ops += S * 2 * R
        sfu = S * (R - 1)
    elif semiring != "tropical":
        raise ValueError(f"unknown semiring {semiring!r}")
    return Work(float(ops), float(sfu), 0.0)


def combine_step(tr: Trellis) -> Work:
    """The LLRs of one step's rho bits from the boundary's alpha and beta:
    S adds for the joint, then for each bit two log-sum-exps over S/2
    states (S - 2 compares, S differences, S - 2 exponentials and S - 2
    adds, two logarithms counted as operations, two adds of the maxima)
    and the difference."""
    S = tr.S
    per_bit_ops = (S - 2) + S + (S - 2) + 2 + 2 + 1
    return Work(float(S + tr.rho * per_bit_ops), float(tr.rho * (S - 2)), 0.0)
