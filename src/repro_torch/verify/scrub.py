"""Online silent-data-corruption scrubbing for the serving engine, the
port of the reference's ``verify/scrub.py`` (host numpy, as there).

A device that raises is handled by retries and failover; one that
silently returns wrong bits is not.  Two stages catch it on a sampled
fraction of dispatches:

1. **Re-encode syndrome check** (:func:`syndrome_check`).  Re-encode the
   decoded bits (``core.encoder.conv_encode``) and compare with the hard
   decisions of the input LLRs.  For a correct decode the mismatches
   are the channel's hard errors; a corrupted message bit adds, in one
   ``k``-stage window, one coded bit per tap of every generator.  Two
   windowed statistics (max over windows of ``2k`` stages) are tested
   against binomial-tail thresholds derived from the LLRs alone (the
   consistency relation of AWGN LLRs, a median-of-windows floor,
   Bonferroni over windows and statistics): the raw mismatch count, and
   the count of mismatches whose ``|llr|`` is at least half the frame's
   mean, where channel errors are rare and corruption is not.
2. **Shadow re-decode** (engine side; :class:`SdcScrubber` names the
   rung).  A flag is confirmed by re-decoding the cell on another rung
   of the degradation ladder and comparing bit for bit: the rungs are
   bit-identical on sound hardware, so a mismatch is corruption, and a
   match a counted false alarm.

The thresholds are the reference's number for number, blind spots
included: a corrupted bit in the last ``k - 1`` stages, or at a
punctured phase, may stay under them.
"""
from __future__ import annotations

import collections
import dataclasses
from math import erfc, exp, lgamma, log, log1p, sqrt
from typing import Optional

import numpy as np

import torch

from repro_torch.core.encoder import conv_encode
from repro_torch.core.validate import InvalidInputError

__all__ = [
    "ScrubVerdict",
    "syndrome_check",
    "SdcScrubber",
    "SHADOW_RUNG",
    "binom_tail",
    "corruption_weight",
]

# Independent rung of the §13 degradation ladder for shadow re-decode:
# a different compiled program (and for sharded, a different device set)
# than the primary, so a device- or program-local corruption cannot
# reproduce itself in the shadow.  Rungs with no true sibling (wava)
# re-run the same program — still a fresh dispatch.
SHADOW_RUNG = {
    "batch": "time_parallel",
    "time_parallel": "batch",
    "sharded": "batch",
    "stream": "stream_xla",
    "stream_xla": "stream",
    "wava": "wava",
}


def binom_tail(n: int, p: float, m: int) -> float:
    """P[Binomial(n, p) >= m], exact, log-domain (n is a window's worth
    of coded bits — tiny)."""
    if m <= 0:
        return 1.0
    if m > n or p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    lp, l1p = log(p), log1p(-p)
    lbase = lgamma(n + 1)
    total = 0.0
    for j in range(m, n + 1):
        total += exp(
            lbase - lgamma(j + 1) - lgamma(n - j + 1) + j * lp
            + (n - j) * l1p
        )
    return min(1.0, total)


def corruption_weight(code, t: int, n: int) -> int:
    """Kept coded bits affected by flipping message bit ``t`` of an
    ``n``-bit frame — the syndrome signal strength of a single-bit SDC
    at that position.

    Linearity of the convolutional encoder makes this exact: the coded
    difference of any two messages differing in bit ``t`` is the coded
    image of the unit vector e_t.  For unpunctured codes away from the
    frame tail this is ``sum(popcount(polys))``; puncturing erases a
    phase-dependent subset and the last ``k - 1`` stages truncate the
    response — the §14 threat model's blind spots.  Tests and chaos
    smokes use this probe to place injections at positions whose weight
    clears the confident threshold (a structural guarantee), and DESIGN
    §14 quotes its minima per registry code.
    """
    spec = code.spec
    e_t = np.zeros(n, dtype=np.int64)
    e_t[t] = 1
    tb = code.termination == "tailbiting"
    diff = conv_encode(e_t, spec, tail_bite=tb)  # zero msg encodes to 0
    if code.puncture is not None:
        from repro_torch.codes.puncture import puncture

        diff = puncture(torch.from_numpy(diff), code.puncture).numpy()
    return int(np.count_nonzero(diff))


@dataclasses.dataclass(frozen=True)
class ScrubVerdict:
    """Outcome of one re-encode syndrome check.

    ``flagged`` means a windowed mismatch statistic exceeded its
    channel-noise threshold — *suspicion*, to be confirmed by shadow
    re-decode.  ``max_window``/``threshold`` expose the raw-count
    statistic, ``max_confident``/``confident_threshold`` the
    confidence-weighted one (the small-``k`` detector); ``mismatches``
    / ``n_compared`` are frame totals and ``p_hat`` the
    (margin-inflated) channel error-rate estimate the raw threshold
    came from.
    """

    flagged: bool
    max_window: int
    threshold: int
    max_confident: int
    confident_threshold: int
    mismatches: int
    n_compared: int
    p_hat: float


def syndrome_check(
    bits,
    llrs,
    code,
    *,
    window_stages: Optional[int] = None,
    alpha: float = 1e-6,
    margin: float = 2.0,
    p_floor: float = 1e-3,
    min_flips: int = 3,
) -> ScrubVerdict:
    """Re-encode ``bits`` and test the hard-decided ``llrs`` against it.

    ``bits`` — (n,) decoded message bits; ``llrs`` — the frame's input
    as submitted: (n, beta) stage-shaped, or the serial (Lp,) kept
    stream for a punctured ``code`` (a registry ``StandardCode``).
    Zero LLRs (erasures, padding) are excluded from the comparison.
    Tail-biting codes re-encode circularly; zero-terminated frames whose
    tail is included in ``bits`` re-encode from state 0 exactly.

    Both thresholds adapt to the data — but NOT to the mismatches
    themselves (a corruption would then inflate its own threshold and
    mask itself).  The per-bit channel rates come from the LLR
    *consistency relation*: a true AWGN LLR has ``var = 2 * mean``, so
    ``mu = sqrt(1 + E[llr^2]) - 1`` estimates the mean and the
    wrong-sign probability is ``Q(sqrt(mu/2))`` (confident wrong-sign:
    ``Q(1.5 * sqrt(mu/2))``) — estimated from the received LLRs only,
    which corruption of the *output* cannot touch.  A median-of-windows
    empirical rate is taken as a floor against model violations (it is
    robust as long as corruption spans under half the windows).  The
    flag then fires on the smallest window count ``m >= min_flips``
    whose Bonferroni-corrected binomial tail ``2 * n_windows *
    P[Bin(n_window_bits, margin * rate) >= m]`` is below ``alpha``.
    A clean decode's mismatches ARE the channel errors, so the
    false-positive rate is bounded by ``alpha`` by construction;
    corruption of even one message bit lands ``~sum(popcount(polys))``
    extra *confident* mismatches inside one window, above the
    confident threshold at operating SNRs (the §14 false-negative
    math).  Inputs that are not LLR-consistent (garbage, adversarial
    scale) drive the estimated rates up and the checker goes quiet
    rather than noisy — by design: the scrubber hunts corrupt
    *decodes*, and the shadow re-decode is the authority.
    """
    spec = code.spec
    bits = np.asarray(bits).astype(np.int64).reshape(-1)
    llrs = np.asarray(llrs, dtype=np.float32)
    n = bits.shape[0]
    if llrs.ndim == 1:
        if code.puncture is None:
            raise InvalidInputError(
                f"serial LLR stream for unpunctured code "
                f"{getattr(code, 'name', '?')}", reason="puncture"
            )
        from repro_torch.codes.puncture import depuncture

        llrs = depuncture(torch.from_numpy(llrs), code.puncture, n=n).numpy()
    if llrs.ndim != 2 or llrs.shape[0] != n:
        raise InvalidInputError(
            f"llrs shape {llrs.shape} does not match {n} decoded stages",
            reason="shape",
        )
    if llrs.shape[1] != spec.beta:
        raise InvalidInputError(
            f"llrs beta={llrs.shape[1]} != code beta={spec.beta}",
            reason="shape",
        )
    coded = conv_encode(
        bits, spec, tail_bite=(code.termination == "tailbiting")
    )
    # channel convention (core/channel.py): bit 0 -> +1 symbol, so a
    # positive LLR votes for bit 0; hard decision = sign test
    hard = (llrs < 0.0).astype(np.int64)
    avail = llrs != 0.0
    mm = (coded != hard) & avail
    n_compared = int(avail.sum())
    mismatches = int(mm.sum())
    if n_compared == 0:
        return ScrubVerdict(
            False, 0, min_flips, 0, min_flips, 0, 0, p_floor
        )

    # channel errors hug the decision boundary; corruption flips sit at
    # typical magnitudes — "confident" = at least half the mean |llr|
    mag = np.abs(llrs)
    scale = float(mag[avail].mean())
    conf = mm & (mag >= 0.5 * scale)

    w = window_stages or 2 * spec.k
    w = max(1, min(w, n))
    kern = np.ones(w, dtype=np.int64)
    win_avail = np.convolve(
        avail.sum(axis=1).astype(np.int64), kern, mode="valid"
    )
    win_mm = np.convolve(mm.sum(axis=1).astype(np.int64), kern, "valid")
    win_conf = np.convolve(conf.sum(axis=1).astype(np.int64), kern, "valid")
    n_windows = win_mm.shape[0]
    n_win_bits = int(win_avail.max())
    budget = alpha / 2.0  # Bonferroni over the two statistics

    # channel rates from the LLR consistency relation (var = 2*mean for
    # true AWGN LLRs) — a function of the INPUT only, so output
    # corruption cannot inflate its own threshold
    m2 = float((llrs[avail] ** 2).mean())
    mu = sqrt(1.0 + m2) - 1.0
    ratio = sqrt(mu / 2.0) if mu > 0 else 0.0
    p_model = 0.5 * erfc(ratio / sqrt(2.0))
    q_model = 0.5 * erfc(1.5 * ratio / sqrt(2.0))
    # median-of-windows empirical floor: robust to corruption spanning
    # < half the windows, catches non-AWGN model violations
    p_emp = float(np.median(win_mm)) / n_win_bits
    q_emp = float(np.median(win_conf)) / n_win_bits

    def _threshold(rate: float) -> int:
        p = min(0.5, max(p_floor, margin * rate))
        for m in range(max(1, min_flips), n_win_bits + 1):
            if n_windows * binom_tail(n_win_bits, p, m) <= budget:
                return m
        return n_win_bits + 1  # bound never met: never flag

    threshold = _threshold(max(p_model, p_emp))
    confident_threshold = _threshold(max(q_model, q_emp))
    max_window = int(win_mm.max())
    max_confident = int(win_conf.max())
    return ScrubVerdict(
        flagged=(max_window >= threshold
                 or max_confident >= confident_threshold),
        max_window=max_window,
        threshold=threshold,
        max_confident=max_confident,
        confident_threshold=confident_threshold,
        mismatches=mismatches,
        n_compared=n_compared,
        p_hat=min(0.5, max(p_floor, margin * max(p_model, p_emp))),
    )


class SdcScrubber:
    """Sampling policy + counters for the engine's online scrubber.

    ``rate`` is the sampled fraction of batch dispatches (0 disables —
    and with 0 the engine makes NO extra calls at all, keeping output
    bit-identical to an unscrubbed engine).  Sampling is a deterministic
    accumulator cadence (every ``1/rate``-th dispatch), so a replayed
    workload scrubs the same dispatches every run.  ``shadow=False``
    skips the confirmation re-decode (syndrome flags then count as
    suspicions only and never quarantine — useful for measurement).

    Counters (all surfaced via ``engine.stats()["scrub"]``):

      * ``sampled``            — dispatches scrubbed
      * ``frames``             — frames syndrome-checked
      * ``syndrome_flags``     — frames whose syndrome flagged
      * ``shadow_dispatches``  — confirmation re-decodes issued
      * ``confirmed``          — frames confirmed corrupt (SDC)
      * ``false_alarms``       — flags the shadow decode cleared
    """

    def __init__(
        self,
        rate: float = 0.05,
        shadow: bool = True,
        alpha: float = 1e-6,
        margin: float = 2.0,
        p_floor: float = 1e-3,
        min_flips: int = 3,
    ):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"scrub rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.shadow = bool(shadow)
        self.alpha = alpha
        self.margin = margin
        self.p_floor = p_floor
        self.min_flips = min_flips
        self._acc = 0.0
        self.counts: collections.Counter = collections.Counter()

    @property
    def enabled(self) -> bool:
        return self.rate > 0.0

    def sample(self) -> bool:
        """Deterministic cadence: True for the dispatches whose index
        crosses a 1/rate boundary (rate=1 -> every dispatch)."""
        if self.rate <= 0.0:
            return False
        self._acc += self.rate
        if self._acc >= 1.0 - 1e-12:
            self._acc -= 1.0
            self.counts["sampled"] += 1
            return True
        return False

    def check_frame(self, bits, llrs, code) -> ScrubVerdict:
        self.counts["frames"] += 1
        v = syndrome_check(
            bits, llrs, code,
            alpha=self.alpha, margin=self.margin,
            p_floor=self.p_floor, min_flips=self.min_flips,
        )
        if v.flagged:
            self.counts["syndrome_flags"] += 1
        return v

    def shadow_path(self, path: str) -> str:
        return SHADOW_RUNG.get(path, "batch")

    def stats(self) -> dict:
        return {
            "rate": self.rate,
            "sampled": int(self.counts["sampled"]),
            "frames": int(self.counts["frames"]),
            "syndrome_flags": int(self.counts["syndrome_flags"]),
            "shadow_dispatches": int(self.counts["shadow_dispatches"]),
            "confirmed": int(self.counts["confirmed"]),
            "false_alarms": int(self.counts["false_alarms"]),
        }
