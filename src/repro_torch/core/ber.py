"""BER measurement harness and binomial estimator layer (paper §IX-B,
Fig. 12).

transmitter (random bits -> conv encoder) -> AWGN channel -> receiver
(LLR former -> Viterbi decoder) -> compare with the source bits.

The estimator layer turns raw (errors, bits) counts into confidence-
bounded BER estimates: Wilson score and Clopper-Pearson (exact) binomial
intervals, and the one-sided zero-error upper bound: a point that
observed 0 errors over n bits reports ``1 - (1-conf)^(1/n)`` (the exact
Clopper-Pearson bound whose small-n face is the "rule of three" 3/n),
never 0.0.  The estimators are plain Python (scipy's quantiles where it
is installed), the same as the reference's.

The noise comes from a ``torch.Generator``: a run is reproducible from
its seed, but draws other numbers than the reference's ``jax.random``
keys, and a CPU generator and a CUDA generator draw different numbers
from one seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import channel as ch
from .backend import resolve_device
from .encoder import conv_encode_torch
from .trellis import CodeSpec
from .viterbi import AcsPrecision, TiledDecoderConfig, tiled_decode_stream

__all__ = [
    "BerPoint",
    "BerEstimate",
    "estimate_ber",
    "wilson_interval",
    "clopper_pearson",
    "zero_error_upper",
    "rule_of_three",
    "measure_ber",
    "ber_curve",
    "uncoded_ber_theory",
]

DEFAULT_CONFIDENCE = 0.99


# ---------------------------------------------------------------------------
# Binomial proportion intervals (DESIGN.md §11)
# ---------------------------------------------------------------------------

def _norm_ppf(q: float) -> float:
    """Standard-normal quantile.  scipy when available, else the
    Acklam rational approximation (|rel err| < 1.15e-9 — far below any
    tolerance a BER interval carries)."""
    try:
        from scipy.special import ndtri

        return float(ndtri(q))
    except ImportError:
        pass
    if not 0.0 < q < 1.0:
        raise ValueError(f"quantile must be in (0, 1), got {q}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    p_low = 0.02425
    if q < p_low:
        u = math.sqrt(-2.0 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                * u + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u + d[3])
                               * u + 1.0)
    if q > 1.0 - p_low:
        return -_norm_ppf(1.0 - q)
    u = q - 0.5
    r = u * u
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
            * r + a[5]) * u / (((((b[0] * r + b[1]) * r + b[2]) * r
                                 + b[3]) * r + b[4]) * r + 1.0)


def _beta_ppf(q: float, a: float, b: float) -> float:
    """Quantile of Beta(a, b).  scipy's betaincinv when available, else
    bisection on the regularized incomplete beta (``_betainc``): 60
    halvings pin the root to ~1e-18 absolute."""
    try:
        from scipy.special import betaincinv

        return float(betaincinv(a, b, q))
    except ImportError:
        pass
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _betainc(a, b, mid) < q:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _betainc(a: float, b: float, x: float) -> float:
    """Regularized incomplete beta I_x(a, b) by its continued fraction
    (modified Lentz), on the side of x where it converges fast: the
    fallback of ``_beta_ppf`` where scipy is absent."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    if x > (a + 1.0) / (a + b + 2.0):
        return 1.0 - _betainc(b, a, 1.0 - x)
    log_front = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
                 + a * math.log(x) + b * math.log1p(-x))
    tiny = 1e-300
    c, d = 1.0, 1.0 - (a + b) * x / (a + 1.0)
    d = 1.0 / (d if abs(d) > tiny else tiny)
    f = d
    for m in range(1, 10000):
        for num in (
            m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m)),
            -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1)),
        ):
            d = 1.0 + num * d
            d = 1.0 / (d if abs(d) > tiny else tiny)
            c = 1.0 + num / c
            c = c if abs(c) > tiny else tiny
            f *= c * d
        if abs(c * d - 1.0) < 1e-16:
            break
    return math.exp(log_front) * f / a


def wilson_interval(
    n_errors: int, n_bits: int, confidence: float = DEFAULT_CONFIDENCE
) -> Tuple[float, float]:
    """Two-sided Wilson score interval for a binomial proportion.

    Approximate but well-behaved at the extremes (never collapses to a
    zero-width interval at k=0 or k=n, unlike the Wald interval)."""
    if n_bits <= 0:
        raise ValueError(f"n_bits must be positive, got {n_bits}")
    if not 0 <= n_errors <= n_bits:
        raise ValueError(f"n_errors={n_errors} outside [0, {n_bits}]")
    z = _norm_ppf(1.0 - (1.0 - confidence) / 2.0)
    n = float(n_bits)
    p = n_errors / n
    z2 = z * z
    denom = 1.0 + z2 / n
    centre = (p + z2 / (2.0 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1.0 - p) / n + z2 / (4.0 * n * n))
    return (max(0.0, centre - half), min(1.0, centre + half))


def clopper_pearson(
    n_errors: int, n_bits: int, confidence: float = DEFAULT_CONFIDENCE
) -> Tuple[float, float]:
    """Exact (Clopper-Pearson) two-sided binomial interval via the beta
    quantile duality: guaranteed >= ``confidence`` coverage at any
    (k, n) — the interval the regression gate trusts."""
    if n_bits <= 0:
        raise ValueError(f"n_bits must be positive, got {n_bits}")
    if not 0 <= n_errors <= n_bits:
        raise ValueError(f"n_errors={n_errors} outside [0, {n_bits}]")
    alpha = 1.0 - confidence
    k, n = n_errors, n_bits
    lo = 0.0 if k == 0 else _beta_ppf(alpha / 2.0, k, n - k + 1)
    hi = 1.0 if k == n else _beta_ppf(1.0 - alpha / 2.0, k + 1, n - k)
    return (lo, hi)


def zero_error_upper(
    n_bits: int, confidence: float = DEFAULT_CONFIDENCE
) -> float:
    """One-sided upper confidence bound on p when 0 errors were observed
    in ``n_bits`` trials: the exact Clopper-Pearson k=0 face,
    ``1 - (1-conf)^(1/n)`` (-> -ln(1-conf)/n for large n; 3/n at 95% is
    the classical "rule of three")."""
    if n_bits <= 0:
        raise ValueError(f"n_bits must be positive, got {n_bits}")
    return 1.0 - (1.0 - confidence) ** (1.0 / n_bits)


def rule_of_three(n_bits: int) -> float:
    """The classical 95% zero-error upper bound, 3/n — the quick mental
    model for ``zero_error_upper(n, 0.95)``."""
    if n_bits <= 0:
        raise ValueError(f"n_bits must be positive, got {n_bits}")
    return 3.0 / n_bits


@dataclasses.dataclass(frozen=True)
class BerEstimate:
    """A confidence-bounded BER estimate from raw (errors, bits) counts.

    ``ber`` is k/n when errors were observed; with ZERO errors it is the
    one-sided upper bound at ``confidence`` (and ``upper_bound`` is set)
    — a finite sample never reports 0.0 (DESIGN.md §11).  ``ci_lo`` /
    ``ci_hi`` bound the true BER at ``confidence`` by ``method``.
    """

    n_bits: int
    n_errors: int
    confidence: float
    ber: float
    ci_lo: float
    ci_hi: float
    method: str
    upper_bound: bool

    @property
    def reliable(self) -> bool:
        """Paper's rule of thumb: >= 100 observed errors."""
        return self.n_errors >= 100


def estimate_ber(
    n_errors: int,
    n_bits: int,
    confidence: float = DEFAULT_CONFIDENCE,
    method: str = "clopper-pearson",
) -> BerEstimate:
    """Counts -> ``BerEstimate`` (the single entry point the farm, the
    gate and the benches share)."""
    if method == "clopper-pearson":
        lo, hi = clopper_pearson(n_errors, n_bits, confidence)
    elif method == "wilson":
        lo, hi = wilson_interval(n_errors, n_bits, confidence)
    else:
        raise ValueError(
            f"unknown interval method {method!r}; "
            "known: clopper-pearson, wilson"
        )
    if n_errors == 0:
        ber = zero_error_upper(n_bits, confidence)
        upper = True
    else:
        ber = n_errors / n_bits
        upper = False
    return BerEstimate(
        n_bits=n_bits,
        n_errors=n_errors,
        confidence=confidence,
        ber=ber,
        ci_lo=lo,
        ci_hi=hi,
        method=method,
        upper_bound=upper,
    )


@dataclasses.dataclass
class BerPoint:
    ebn0_db: float
    n_bits: int
    n_errors: int

    @property
    def ber(self) -> float:
        return self.n_errors / max(self.n_bits, 1)

    @property
    def reliable(self) -> bool:
        """Paper's rule of thumb: BER > 100/n is trustworthy."""
        return self.n_errors >= 100

    def estimate(
        self, confidence: float = DEFAULT_CONFIDENCE,
        method: str = "clopper-pearson",
    ) -> BerEstimate:
        """Confidence-bounded view of this point (DESIGN.md §11)."""
        return estimate_ber(
            self.n_errors, self.n_bits, confidence=confidence, method=method
        )


def uncoded_ber_theory(ebn0_db: float) -> float:
    """Q(sqrt(2 Eb/N0)) — uncoded BPSK reference curve."""
    from math import erfc, sqrt

    ebn0 = 10.0 ** (ebn0_db / 10.0)
    return 0.5 * erfc(sqrt(ebn0))


def measure_ber(
    spec: CodeSpec,
    ebn0_db: float,
    n_bits: int,
    generator: torch.Generator,
    cfg: TiledDecoderConfig = TiledDecoderConfig(),
    precision: AcsPrecision = AcsPrecision(),
    hard: bool = False,
    use_kernel: bool = True,
    decoder: Optional[Callable] = None,
    device=None,
) -> BerPoint:
    """One point of the Fig. 12 verification pipeline: ``n_bits`` random
    bits and their noise drawn from ``generator`` (on its own device),
    decoded on ``device`` (None is the card) by ``tiled_decode_stream``
    or by ``decoder``.  ``hard`` feeds the decoder +-1 hard decisions.

    ``use_kernel`` defaults to True, a departure from the reference,
    whose default is False: on the card ``use_kernel=False`` runs the
    plain per-step scan, which the port keeps for explicit requests.
    On the CPU the kernel wrappers run their plain versions."""
    dev = resolve_device(device)
    gdev = generator.device
    bits = torch.randint(0, 2, (n_bits,), generator=generator, device=gdev)
    coded = conv_encode_torch(bits, spec)  # (n, beta)
    rx = ch.awgn(generator, ch.bpsk(coded), ebn0_db, spec.rate)
    if hard:
        llrs = ch.hard_decision(rx)
    else:
        llrs = ch.llr(rx, ebn0_db, spec.rate)
    llrs = llrs.to(precision.channel_dtype).to(torch.float32).to(dev)
    if decoder is None:
        decoded = tiled_decode_stream(
            llrs, spec, cfg, precision=precision, use_kernel=use_kernel,
            device=dev,
        )
    else:
        decoded = decoder(llrs)
    n_err = int((decoded[:n_bits].to(dev) != bits.to(dev)).sum())
    return BerPoint(ebn0_db=ebn0_db, n_bits=n_bits, n_errors=n_err)


def ber_curve(
    spec: CodeSpec,
    ebn0_dbs: Sequence[float],
    n_bits: int,
    seed: int = 0,
    **kw,
) -> list:
    """``measure_ber`` at each Eb/N0, point i drawing from a CPU generator
    seeded with ``derive_seed(seed, i)``, so a curve is the same whichever
    device decodes it."""
    return [
        measure_ber(
            spec, e, n_bits,
            torch.Generator().manual_seed(ch.derive_seed(seed, i)), **kw,
        )
        for i, e in enumerate(ebn0_dbs)
    ]
