"""Serving entry points: so far the multi-tenant ``DecodeEngine``
factory of the reference's ``serve/step.py``.

The reference's ``make_viterbi_decoder`` and ``make_viterbi_serve_step``
take a ``configs/viterbi_k7.py`` config and wait for its port (with
``ViterbiDecoder.from_config``); its LM step factories wait for the LM
testbed.
"""
from __future__ import annotations

__all__ = ["make_decode_engine"]


def make_decode_engine(precision=None, use_kernel: bool = True, device=None,
                       **kw):
    """The multi-tenant serving entry point: a ``serve.engine.DecodeEngine``
    that buckets ragged mixed-code, mixed-SLO requests into padded (F, T)
    cells and routes each to a decode path on ``device`` (None: the
    card).  It is stateful (queues, callable cache, session table) and
    driven with submit/poll/drain.  Keyword arguments go to
    ``DecodeEngine`` (max_batch, max_wait, session_capacity, mesh, ...).
    ``use_kernel`` defaults to True here, False in the reference."""
    from repro_torch.serve.engine import DecodeEngine

    return DecodeEngine(precision=precision, use_kernel=use_kernel,
                        device=device, **kw)
