"""Serving: the multi-tenant ``DecodeEngine`` with dynamic batch assembly
(``serve.engine``) and its factory (``serve.step.make_decode_engine``)."""
from .engine import (  # noqa: F401
    DEGRADATION_LADDER,
    DecodeEngine,
    DecodeRequest,
    Ticket,
)
from .step import make_decode_engine  # noqa: F401
