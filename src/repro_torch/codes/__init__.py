"""Standard-codes subsystem: the registry of deployed convolutional codes
(CCSDS/DVB-S/802.11a/LTE TBCC/GSM) behind
``ViterbiDecoder.from_standard``.  Puncturing and tail-biting decode come
with a later slice of the port."""
from .puncture import PuncturePattern  # noqa: F401
from .registry import (  # noqa: F401
    REGISTRY,
    StandardCode,
    get_code,
    list_codes,
)
