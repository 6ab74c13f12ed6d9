"""Verification: the Monte-Carlo BER farm (``verify.farm``), its
statistical gate (``verify.gate``), and the online silent-data-corruption
scrubber the serving engine samples its dispatches through
(``verify.scrub``).
"""
from .farm import PATHS, BerFarm, FarmPoint, farm_to_json  # noqa: F401
from .gate import GateVerdict, all_pass, gate_point, run_gate  # noqa: F401
from .scrub import (  # noqa: F401
    SHADOW_RUNG,
    ScrubVerdict,
    SdcScrubber,
    binom_tail,
    corruption_weight,
    syndrome_check,
)

__all__ = [
    "PATHS",
    "BerFarm",
    "FarmPoint",
    "farm_to_json",
    "GateVerdict",
    "gate_point",
    "run_gate",
    "all_pass",
    "ScrubVerdict",
    "SdcScrubber",
    "syndrome_check",
    "corruption_weight",
    "binom_tail",
    "SHADOW_RUNG",
]
