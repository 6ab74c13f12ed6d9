"""Standard-codes subsystem: the registry of deployed convolutional codes
(CCSDS/DVB-S/802.11a/LTE TBCC/GSM), puncturing / rate matching,
tail-biting (WAVA) decode and the end-to-end simulation, all behind the
``ViterbiDecoder`` front door via ``ViterbiDecoder.from_standard``."""
from .puncture import PuncturePattern, depuncture, puncture  # noqa: F401
from .registry import (  # noqa: F401
    REGISTRY,
    StandardCode,
    get_code,
    list_codes,
)
from .simulate import (  # noqa: F401
    encode_standard,
    measure_standard_ber,
    standard_llrs,
    tx_frames,
)
from .tailbiting import tail_bite_state, wava_decode  # noqa: F401
