"""Serving: the multi-tenant ``DecodeEngine`` with dynamic batch assembly
(``serve.engine``), and the step factories of ``serve.step``
(``make_prefill_step``, ``make_decode_step``, ``make_viterbi_decoder``,
``make_viterbi_serve_step``, ``make_decode_engine``)."""
from .engine import (  # noqa: F401
    DEGRADATION_LADDER,
    DecodeEngine,
    DecodeRequest,
    Ticket,
)
from .step import (  # noqa: F401
    make_decode_engine,
    make_decode_step,
    make_prefill_step,
    make_viterbi_decoder,
    make_viterbi_serve_step,
)
