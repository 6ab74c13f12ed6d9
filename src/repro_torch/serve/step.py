"""Serving entry points of the reference's ``serve/step.py``: the LM
testbed's prefill and decode steps (``make_prefill_step``,
``make_decode_step``), the paper's Viterbi stream-decode service
(``make_viterbi_decoder``, ``make_viterbi_serve_step``) and the
multi-tenant ``DecodeEngine`` factory (``make_decode_engine``).

Every Viterbi factory defaults to ``use_kernel=True`` and to the card
(``device=None``); the reference's default is ``use_kernel=False``.  The
LM steps run where their parameters and cache lie.
"""
from __future__ import annotations

import torch

__all__ = [
    "make_prefill_step",
    "make_decode_step",
    "make_viterbi_serve_step",
    "make_viterbi_decoder",
    "make_decode_engine",
]


def make_prefill_step(cfg):
    """prefill_step(params, cache, batch) -> (last logits (B, V) f32,
    cache): ``batch`` holds "tokens" (B, S) and, for a frontend arch,
    "prefix_embeds" (B, prefix_len, d_model)."""
    from repro_torch.models import lm

    def prefill_step(params, cache, batch):
        return lm.prefill(
            params, cfg, batch["tokens"], cache, batch.get("prefix_embeds")
        )

    return prefill_step


def make_decode_step(cfg):
    """decode_step(params, cache, tokens (B, 1)) -> (logits (B, V) f32,
    a new cache)."""
    from repro_torch.models import lm

    def decode_step(params, cache, tokens):
        return lm.decode_step(params, cfg, tokens, cache)

    return decode_step


def make_viterbi_decoder(vcfg, precision=None, use_kernel: bool = True,
                         decision_depth=None, one_pass=None, device=None):
    """The service's ``ViterbiDecoder`` from a ``ViterbiConfig``, on
    ``device`` (None: the card).  ``one_pass`` (None: ``use_kernel``)
    sends streaming chunks and tiled windows through K2."""
    from repro_torch.core.decoder import ViterbiDecoder

    return ViterbiDecoder.from_config(
        vcfg,
        precision=precision,
        use_kernel=use_kernel,
        decision_depth=decision_depth,
        one_pass=one_pass,
        device=device,
    )


def make_decode_engine(precision=None, use_kernel: bool = True, device=None,
                       **kw):
    """The multi-tenant serving entry point: a ``serve.engine.DecodeEngine``
    that buckets ragged mixed-code, mixed-SLO requests into padded (F, T)
    cells and routes each to a decode path on ``device`` (None: the
    card).  It is stateful (queues, callable cache, session table) and
    driven with submit/poll/drain.  Keyword arguments go to
    ``DecodeEngine`` (max_batch, max_wait, session_capacity, mesh, ...)."""
    from repro_torch.serve.engine import DecodeEngine

    return DecodeEngine(precision=precision, use_kernel=use_kernel,
                        device=device, **kw)


def make_viterbi_serve_step(vcfg, precision=None, use_kernel: bool = True,
                            mode: str = "tiled", one_pass=None, device=None):
    """Stateless Viterbi serve step through the ``ViterbiDecoder`` front
    door: llrs (n_streams, stream_len, beta), or the serial kept stream
    (n_streams, Lp) of a punctured config -> bits (n_streams, stream_len)
    int32 on the decoder's device.

    mode="tiled": each stream becomes stream_len/frame_len overlapping
    windows (``decoder.default_tiled_config(vcfg.tiled)``: the overlap
    stretched by a puncture's expansion).  The reference maps
    ``decode_stream_tiled`` over the streams with ``jax.vmap``; here every
    stream's windows fold into the frame axis of one window decode
    (``core.viterbi.tiled_decode_streams``): one K2 launch for all the
    streams when the one-pass rule admits the window (the decoder's
    ``one_pass``, by default ``use_kernel``), else one K1 launch and one
    traceback.  Each stream's bits are those of ``decode_stream_tiled``
    on that stream alone.  ``one_pass`` (None: ``use_kernel``) is the
    port's addition: with ``use_kernel=True, one_pass=False`` the windows
    take the two-pass path through K1.

    mode="batch": each stream is one truncated-Viterbi frame
    (``decode_batch``, initial and final state free); a tail-biting
    config decodes through ``decode_tailbiting(...)[0]``.  Tail-biting
    configs serve only this mode.

    The stateful chunked mode is no step function: build the decoder
    with ``make_viterbi_decoder`` and drive ``decode_stream_chunked``
    (``launch/serve.py --mode chunked``).
    """
    from repro_torch.core.decoder import _count_dispatch
    from repro_torch.core.viterbi import tiled_decode_streams
    from repro_torch.obs.trace import stage

    decoder = make_viterbi_decoder(
        vcfg, precision, use_kernel, one_pass=one_pass, device=device)
    if decoder.termination == "tailbiting" and mode != "batch":
        raise ValueError(
            f"tail-biting standard {vcfg.code!r} serves via mode='batch' "
            f"(WAVA decodes frames whole), got mode={mode!r}"
        )
    if mode == "tiled":
        cfg = decoder.default_tiled_config(vcfg.tiled)

        def serve_step(llrs) -> torch.Tensor:
            with stage("decode", device=decoder.device) as sp:
                with stage("front_door", device=decoder.device):
                    llrs = decoder._harden(decoder.depunctured(llrs))
                sp.set(path="tiled")
                _count_dispatch("tiled")
                return tiled_decode_streams(
                    llrs,
                    decoder.spec,
                    cfg,
                    precision=decoder.precision,
                    use_kernel=decoder.use_kernel,
                    pack_survivors=decoder.pack_survivors,
                    one_pass=decoder.one_pass,
                    time_tile=decoder.time_tile,
                    block_frames=decoder.block_frames,
                    time_parallel=decoder.time_parallel,
                    transfer_tile=decoder.transfer_tile,
                    device=decoder.device,
                )
    elif mode == "batch":
        if decoder.termination == "tailbiting":
            def serve_step(llrs) -> torch.Tensor:
                return decoder.decode_tailbiting(llrs)[0]
        else:
            def serve_step(llrs) -> torch.Tensor:
                return decoder.decode_batch(
                    llrs, initial_state=None, final_state=None
                )
    else:
        raise ValueError(f"unknown serve mode {mode!r}")
    return serve_step
