"""Data-plane input hardening and path-metric overflow guards.

The port of the reference's ``core/validate.py``:

  * :func:`validate_llrs` — non-finite samples (NaN/Inf) would otherwise
    flow into the fused max-plus matmuls, where one NaN poisons every
    path metric it touches.  Strict mode raises a typed
    :class:`InvalidInputError`; ``sanitize=True`` clamps instead (NaN ->
    0.0, the no-information erasure; +/-Inf and out-of-range samples ->
    +/-``LLR_CLAMP``) and counts every repaired sample into
    ``decoder_input_sanitized_total{reason, where}``.
  * :class:`RenormGuard` and :func:`batch_headroom_check` — for
    ``AcsPrecision(renorm=False)`` the carry drifts monotonically and a
    narrow carry (bf16: 8 significand bits) absorbs branch increments
    once ``|lam|`` passes ``2**mantissa_digits``.  The guard observes a
    host-visible carry, renormalizes by the per-frame max (which leaves
    the traceback unchanged) past the soft threshold and raises
    :class:`MetricOverflowError` past the hard one; the batch check
    bounds the worst-case drift before a decode that never surfaces its
    carry.  Events go to ``decoder_renorm_guard_total{event}``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs.trace import host_read

__all__ = [
    "LLR_CLAMP",
    "InvalidInputError",
    "MetricOverflowError",
    "validate_llrs",
    "RenormGuard",
    "batch_headroom_check",
]

# Finite clamp for sanitized samples: large enough to dominate any real
# channel LLR, small enough to survive a cast to float16 (max 65504).
LLR_CLAMP = 1.0e4

# Matches semiring.NEG: the one-hot init sentinel for unreachable states.
# Guard statistics must ignore it or the sentinel reads as "overflow".
_NEG_FLOOR = -5.0e8


class InvalidInputError(ValueError):
    """Typed rejection of malformed decoder input.

    ``reason`` is a short machine-readable tag (``"non_finite"``, ...)
    reused as the metric label.  Subclasses ``ValueError``.
    """

    def __init__(self, message: str, reason: str = "invalid"):
        super().__init__(message)
        self.reason = reason


class MetricOverflowError(RuntimeError):
    """Path-metric dynamic range exceeded the carry dtype's headroom.

    The fix is always one of: enable ``renorm=True``, shorten frames, or
    let the guard renormalize between streaming chunks.
    """


def _count(family: str, n: int = 1, **labels) -> None:
    from repro_torch.obs import default_registry

    default_registry().counter(family).inc(n, **labels)


def validate_llrs(
    llrs,
    *,
    sanitize: bool = False,
    clamp: float = LLR_CLAMP,
    where: str = "decoder",
    registry=None,
):
    """Validate (or repair) an LLR array before it reaches the kernels.

    ``llrs`` is a numpy array or a torch tensor; the result keeps its
    kind (and device).  Returns ``(llrs, n_sanitized)``.  Strict mode
    raises :class:`InvalidInputError` with ``reason="non_finite"`` on any
    NaN/Inf sample; sanitize mode repairs and counts per reason (``nan``
    vs ``clamped``), into ``registry`` when one is given (the serving
    engine's), else into the default registry.
    """
    is_np = isinstance(llrs, np.ndarray)
    xp_isfinite = np.isfinite if is_np else torch.isfinite
    finite = host_read(xp_isfinite(llrs).all())
    n_bad = n_nan = n_over = 0
    if not finite or sanitize:
        if is_np:
            arr = llrs.astype(np.float32, copy=False)
            nan = np.isnan(arr)
            over = np.abs(arr) > clamp  # catches +/-Inf too
        else:
            nan = torch.isnan(llrs)
            over = llrs.abs() > clamp
        n_nan = host_read(nan.sum())
        n_over = host_read((over & ~nan).sum())
        n_bad = n_nan + n_over
    if not finite and not sanitize:
        raise InvalidInputError(
            f"{where}: input LLRs contain non-finite samples "
            f"({n_bad} offending); pass sanitize=True to clamp-and-count",
            reason="non_finite",
        )
    if sanitize and n_bad:
        if is_np:
            arr = np.clip(
                np.nan_to_num(
                    llrs.astype(np.float32, copy=True),
                    nan=0.0, posinf=clamp, neginf=-clamp,
                ),
                -clamp, clamp,
            )
        else:
            arr = torch.nan_to_num(
                llrs, nan=0.0, posinf=clamp, neginf=-clamp
            ).clamp(-clamp, clamp)
        if registry is None:
            from repro_torch.obs import default_registry

            registry = default_registry()
        fam = registry.counter("decoder_input_sanitized_total")
        if n_nan:
            fam.inc(n_nan, reason="nan", where=where)
        if n_over:
            fam.inc(n_over, reason="clamped", where=where)
        return arr, n_bad
    return llrs, 0


@dataclasses.dataclass
class RenormGuard:
    """Overflow guard for no-renorm carry metrics.

    ``soft`` is the headroom threshold past which the guard renormalizes
    the carry by its per-frame max; ``hard`` is the give-up point, past
    which the carry has already absorbed increments and the guard raises
    :class:`MetricOverflowError`.  ``interval_steps`` is the observation
    cadence in trellis steps; it halves (floor: one chunk) whenever an
    observation lands above ``soft``.  Use :meth:`for_precision` to
    derive the thresholds from the carry dtype.
    """

    soft: float
    hard: float
    interval_steps: int = 1024
    min_interval_steps: int = 1
    renorms: int = 0
    tightens: int = 0
    observations: int = 0

    @classmethod
    def for_precision(cls, precision, interval_steps: int = 1024
                      ) -> "RenormGuard":
        soft = precision.carry_absorb_limit()
        hard = min(precision.carry_max() / 2.0, soft * 32.0)
        return cls(soft=soft, hard=hard, interval_steps=interval_steps)

    def due(self, pos: int, t_chunk: int) -> bool:
        """True when a chunk ending at ``pos`` crosses an observation
        boundary (every ``interval_steps`` trellis steps)."""
        if t_chunk <= 0:
            return False
        step = max(self.min_interval_steps, self.interval_steps)
        return (pos // step) > ((pos - t_chunk) // step)

    def observe(self, lam: torch.Tensor, t_chunk: int = 0):
        """Observe a host-visible ``(F, S)`` float32 carry; return
        ``(lam, renormed)``.  The NEG sentinel entries of a freshly
        pinned stream are masked out of the magnitude statistic and left
        pinned by the renorm shift."""
        self.observations += 1
        live = lam > _NEG_FLOOR
        mag = host_read(torch.where(live, lam.abs(), 0.0).max())
        if mag >= self.hard:
            _count("decoder_renorm_guard_total", event="overflow")
            raise MetricOverflowError(
                f"carry magnitude {mag:.3g} beyond hard headroom "
                f"{self.hard:.3g}; increments are being absorbed — enable "
                f"AcsPrecision(renorm=True) or widen the carry dtype"
            )
        if mag >= self.soft:
            mx = torch.where(live, lam, -torch.inf).amax(dim=-1, keepdim=True)
            lam = torch.where(live, lam - mx, lam)
            self.renorms += 1
            _count("decoder_renorm_guard_total", event="renorm")
            if t_chunk and self.interval_steps > max(
                    t_chunk, self.min_interval_steps):
                # drift reached soft headroom within one cadence window:
                # sample twice as often next time
                self.interval_steps = max(
                    t_chunk, self.min_interval_steps,
                    self.interval_steps // 2,
                )
                self.tightens += 1
                _count("decoder_renorm_guard_total", event="tighten")
            return lam, True
        return lam, False

    def stats(self) -> dict:
        return {
            "observations": self.observations,
            "renorms": self.renorms,
            "tightens": self.tightens,
            "interval_steps": self.interval_steps,
        }


def batch_headroom_check(precision, t_steps: int, llr_absmax: float,
                         rho: int, beta: int) -> None:
    """Pre-dispatch headroom assertion for un-chunked no-renorm decodes.

    Bounds the worst-case drift (``t_steps`` radix steps, each adding at
    most ``rho*beta`` coded-bit potentials of ``llr_absmax``) and raises
    before a decode whose carry would wrap to Inf.  Absorption-only risk
    (past the soft limit, far from the dtype max) is counted, not raised.
    """
    if precision.renorm:
        return
    bound = float(t_steps) * float(llr_absmax) * float(rho * beta)
    if bound > precision.carry_max() / 4.0:
        _count("decoder_renorm_guard_total", event="overflow")
        raise MetricOverflowError(
            f"no-renorm decode of {t_steps} steps with max|llr|="
            f"{llr_absmax:.3g} can drift to ~{bound:.3g}, past the "
            f"{str(precision.carry_dtype).replace('torch.', '')} range "
            f"({precision.carry_max():.3g}); enable renorm or stream "
            f"in chunks (the guard renormalizes between chunks)"
        )
    if bound > precision.carry_absorb_limit():
        _count("decoder_renorm_guard_total", event="headroom")
