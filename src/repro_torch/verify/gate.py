"""Statistical regression gate, the port of the reference's
``verify/gate.py`` (DESIGN.md §11).

Every accelerated decode path is measured by the farm at the SAME noise
realizations as the reference decode (``codes.simulate.batch_keys``), so
a bit-exact path produces *identical* error counts — the gate's fast
path.  Paths that are only statistically equivalent (different
traceback boundary handling, low-precision metrics) pass when their
Clopper-Pearson BER intervals overlap the reference's; a path whose
interval EXCLUDES the reference curve at every shared confidence is a
statistical regression and fails the gate.

The pass rule is deliberately interval-overlap (not point-in-interval):
both measurements are noisy, and with matched noise the exact test
already catches every bitwise change — the interval test only has to
price genuine statistical drift.  It is also the only test that can
hold the port's farm to the reference's: their noise streams differ
(``torch.Generator`` against ``jax.random``), so the two BERs meet by
interval overlap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ber import DEFAULT_CONFIDENCE, estimate_ber

from .farm import FarmPoint

__all__ = ["GateVerdict", "gate_point", "run_gate", "all_pass"]

REFERENCE_PATH = "reference"


@dataclasses.dataclass(frozen=True)
class GateVerdict:
    """One gate decision: test path vs reference at one grid point."""

    code: str
    path: str
    ebn0_db: float
    passed: bool
    reason: str
    ref_point: FarmPoint
    test_point: FarmPoint

    @property
    def label(self) -> str:
        return f"{self.code}/{self.path}@ebn0={self.ebn0_db}"


def gate_point(
    ref: FarmPoint,
    test: FarmPoint,
    confidence: Optional[float] = None,
) -> GateVerdict:
    """Gate one (code, Eb/N0) cell of one accelerated path.

    Pass when (a) the counts are identical — matched noise makes this
    the expected outcome for bit-exact paths — or (b) the two
    Clopper-Pearson intervals at ``confidence`` overlap.  Fail when the
    test interval excludes the whole reference interval (and therefore
    the reference curve)."""
    if (ref.code, ref.ebn0_db) != (test.code, test.ebn0_db):
        raise ValueError(
            f"gate pairs must share a grid cell: "
            f"{(ref.code, ref.ebn0_db)} vs {(test.code, test.ebn0_db)}"
        )
    conf = confidence or max(ref.confidence, test.confidence,
                             DEFAULT_CONFIDENCE)
    if (ref.bit_errors, ref.n_bits) == (test.bit_errors, test.n_bits):
        return GateVerdict(
            code=test.code, path=test.path, ebn0_db=test.ebn0_db,
            passed=True,
            reason=(
                f"exact: identical counts "
                f"({test.bit_errors}/{test.n_bits})"
            ),
            ref_point=ref, test_point=test,
        )
    r = estimate_ber(ref.bit_errors, ref.n_bits, confidence=conf)
    t = estimate_ber(test.bit_errors, test.n_bits, confidence=conf)
    overlap = t.ci_lo <= r.ci_hi and r.ci_lo <= t.ci_hi
    span = (
        f"test [{t.ci_lo:.3e}, {t.ci_hi:.3e}] vs "
        f"ref [{r.ci_lo:.3e}, {r.ci_hi:.3e}] @{conf:g}"
    )
    return GateVerdict(
        code=test.code, path=test.path, ebn0_db=test.ebn0_db,
        passed=overlap,
        reason=("ci-overlap: " if overlap else "ci-disjoint: ") + span,
        ref_point=ref, test_point=test,
    )


def run_gate(
    points: Sequence[FarmPoint],
    reference: str = REFERENCE_PATH,
    confidence: Optional[float] = None,
) -> List[GateVerdict]:
    """Pair every accelerated path's points with the reference path's at
    the same (code, Eb/N0) cell and gate each pair.  A cell measured on
    an accelerated path but missing its reference is itself a FAIL (the
    gate never silently skips coverage)."""
    refs: Dict[Tuple[str, float], FarmPoint] = {
        (p.code, p.ebn0_db): p for p in points if p.path == reference
    }
    verdicts: List[GateVerdict] = []
    for p in points:
        if p.path == reference:
            continue
        ref = refs.get((p.code, p.ebn0_db))
        if ref is None:
            verdicts.append(
                GateVerdict(
                    code=p.code, path=p.path, ebn0_db=p.ebn0_db,
                    passed=False,
                    reason=f"no {reference!r} measurement for this cell",
                    ref_point=p, test_point=p,
                )
            )
            continue
        verdicts.append(gate_point(ref, p, confidence=confidence))
    return verdicts


def all_pass(verdicts: Sequence[GateVerdict]) -> bool:
    return all(v.passed for v in verdicts)
