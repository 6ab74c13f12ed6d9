"""Verification: so far the online silent-data-corruption scrubber the
serving engine samples its dispatches through (``verify.scrub``).

The reference's BER farm (``verify/farm.py``) and statistical gate
(``verify/gate.py``) are not ported yet.
"""
from .scrub import (  # noqa: F401
    SHADOW_RUNG,
    ScrubVerdict,
    SdcScrubber,
    binom_tail,
    corruption_weight,
    syndrome_check,
)

__all__ = [
    "ScrubVerdict",
    "SdcScrubber",
    "syndrome_check",
    "corruption_weight",
    "binom_tail",
    "SHADOW_RUNG",
]
