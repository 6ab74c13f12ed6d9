"""Standard-code registry: every deployed Viterbi workload is a mother
code plus a puncture pattern and a termination rule.

The same entries as the reference's ``codes/registry.py``.  Polynomials
are k-bit integers with the MSB applying to the current input bit (the
octal values printed in the standards).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.trellis import CodeSpec

from .puncture import PuncturePattern

__all__ = ["StandardCode", "REGISTRY", "get_code", "list_codes"]


# Puncture patterns, rows = stages (the standards' puncturing matrices
# transposed).  802.11a §17.3.5.6 / DVB-S (EN 300 421 Table 2) share the
# K=7 mother-code patterns.
P_R23 = PuncturePattern(mask=((1, 1), (1, 0)))  # keep A0 B0 A1
P_R34 = PuncturePattern(mask=((1, 1), (1, 0), (0, 1)))  # A0 B0 A1 B2
P_R56 = PuncturePattern(  # X:10101 Y:11010 (DVB-S / 802.11n)
    mask=((1, 1), (0, 1), (1, 0), (0, 1), (1, 0))
)
P_R78 = PuncturePattern(  # DVB-S X:1000101 Y:1111010
    mask=((1, 1), (0, 1), (0, 1), (0, 1), (1, 0), (0, 1), (1, 0))
)


@dataclasses.dataclass(frozen=True)
class StandardCode:
    """One deployable workload: mother code + rate matching + termination."""

    name: str
    spec: CodeSpec
    puncture: Optional[PuncturePattern] = None
    termination: str = "zero"  # "zero" | "tailbiting"
    family: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.termination not in ("zero", "tailbiting"):
            raise ValueError(f"unknown termination {self.termination!r}")
        if self.puncture is not None and self.puncture.beta != self.spec.beta:
            raise ValueError(
                f"{self.name}: puncture beta={self.puncture.beta} != "
                f"code beta={self.spec.beta}"
            )

    @property
    def rate(self) -> float:
        """Effective code rate after rate matching."""
        if self.puncture is None:
            return self.spec.rate
        return self.puncture.rate(self.spec.beta)

    @property
    def expansion(self) -> float:
        """Depunctured stages per kept-bit-equivalent stage (≥ 1)."""
        return 1.0 if self.puncture is None else self.puncture.expansion

    def coded_len(self, n_bits: int) -> int:
        """Transmitted coded bits for an n_bits message (no tail bits
        for tail-biting; the zero tail, if used, is part of n_bits)."""
        if self.puncture is None:
            return n_bits * self.spec.beta
        return self.puncture.punctured_len(n_bits)


_K7_CCSDS = CodeSpec(k=7, polys=(0o171, 0o133))  # CCSDS / DVB-S (G1, G2)
_K7_WIFI = CodeSpec(k=7, polys=(0o133, 0o171))  # 802.11a (g0=133 first)
_K7_LTE = CodeSpec(k=7, polys=(0o133, 0o171, 0o165))  # 36.212 TBCC, rate 1/3
_K5_GSM = CodeSpec(k=5, polys=(0o23, 0o33))  # GSM 05.03 CS-1

REGISTRY: Dict[str, StandardCode] = {
    c.name: c
    for c in [
        StandardCode(
            "ccsds-k7", _K7_CCSDS, family="ccsds",
            notes="the paper's §IX-A code: (2,1,7), 171/133, zero-terminated",
        ),
        StandardCode(
            "dvb-s", _K7_CCSDS, family="dvb",
            notes="DVB-S mother code (same 171/133 polynomials)",
        ),
        StandardCode(
            "dvb-s-r78", _K7_CCSDS, puncture=P_R78, family="dvb",
            notes="DVB-S rate 7/8 (EN 300 421 Table 2)",
        ),
        StandardCode(
            "wifi-11a", _K7_WIFI, family="wifi",
            notes="802.11a/g BCC rate 1/2, 133/171",
        ),
        StandardCode(
            "wifi-11a-r23", _K7_WIFI, puncture=P_R23, family="wifi",
            notes="802.11a/g rate 2/3 (§17.3.5.6)",
        ),
        StandardCode(
            "wifi-11a-r34", _K7_WIFI, puncture=P_R34, family="wifi",
            notes="802.11a/g rate 3/4 (§17.3.5.6)",
        ),
        StandardCode(
            "wifi-11a-r56", _K7_WIFI, puncture=P_R56, family="wifi",
            notes="802.11n-style rate 5/6 from the same mother code",
        ),
        StandardCode(
            "lte-tbcc", _K7_LTE, termination="tailbiting", family="lte",
            notes="LTE TBCC (36.212 §5.1.3.1): rate 1/3, 133/171/165, "
            "tail-biting (decoded with WAVA)",
        ),
        StandardCode(
            "gsm-cs1", _K5_GSM, family="gsm",
            notes="GSM 05.03 CS-1 convolutional code: (2,1,5), 23/33",
        ),
    ]
}


def get_code(name: str) -> StandardCode:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown standard code {name!r}; known: {sorted(REGISTRY)}"
        ) from None


def list_codes() -> list:
    return sorted(REGISTRY)
