"""Data pipelines.

Two sources, both deterministic and host-shardable:
  * ``TokenStream`` — synthetic LM token batches (training the testbed's
    architectures without an external corpus);
  * ``ChannelStream`` — the paper's pipeline (Fig. 12): random bits ->
    convolutional encoder -> BPSK + AWGN -> LLR frames, for the Viterbi
    decoder service and BER measurements.

Determinism: batch ``i`` of host ``h`` is a pure function of
(seed, h, i), so restarts resume exactly and any host can regenerate any
shard.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from repro_torch.core import channel as ch
from repro_torch.core.backend import resolve_device
from repro_torch.core.encoder import conv_encode_torch
from repro_torch.core.trellis import CODE_K7_CCSDS, CodeSpec

__all__ = ["TokenStream", "ChannelStream"]


@dataclasses.dataclass
class TokenStream:
    """Synthetic LM batches with a Zipfian unigram + bigram structure, so
    that the loss falls measurably over a short training run.

    Batch ``step`` draws from a ``torch.Generator`` on ``device`` (None:
    the card) seeded with the reference's integer ``(seed * 1_000_003 +
    host_id) * 1_000_003 + step``: tokens ``int(V * u**3)`` for uniform
    ``u`` (a Zipf-ish marginal), every even position then set to
    ``(previous token // 2) % V``, labels the tokens rolled left by one
    with the last set to -1, and for a frontend arch (``prefix_len``)
    bf16 ``prefix_embeds`` of 0.02 x standard normals.  The draws are not
    ``jax.random``'s: the structure is the reference's, the numbers are
    not, and the tests feed both packages the same numpy batches."""

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    prefix_len: int = 0
    d_model: int = 0
    device: Optional[object] = None

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> dict:
        dev = resolve_device(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(
            ((self.seed * 1_000_003 + self.host_id) * 1_000_003 + step) % 2**64)
        u = torch.rand((self.batch, self.seq_len), generator=gen, device=dev)
        toks = (self.vocab_size * u**3).to(torch.int32)
        # inject determinism: every token at an even position copies prev // 2
        prev = torch.roll(toks, 1, dims=1)
        even = (torch.arange(self.seq_len, device=dev) % 2 == 0)[None, :]
        toks = torch.where(even, torch.remainder(prev // 2, self.vocab_size), toks)
        labels = torch.roll(toks, -1, dims=1)
        labels[:, -1] = -1
        out = {"tokens": toks, "labels": labels}
        if self.prefix_len:
            out["prefix_embeds"] = (0.02 * torch.randn(
                (self.batch, self.prefix_len, self.d_model), generator=gen,
                device=dev)).to(torch.bfloat16)
        return out


@dataclasses.dataclass
class ChannelStream:
    """Paper Fig. 12 transmitter + channel: yields (bits, llrs) batches.

    ``code`` names a ``repro_torch.codes.registry`` standard: the stream
    is then encoded with that code's termination (tail-biting needs no
    tail), punctured to its rate, and the LLRs come back as the serial
    kept stream (n_streams, Lp), which is what a punctured
    ``ViterbiDecoder.from_standard`` consumes.  ``code=None`` gives
    (n_streams, stream_len, beta) LLRs of ``spec``.

    Bits and noise are drawn on ``device`` (None is the card) from a
    generator seeded by ``key_at``; a CPU stream and a card stream of
    one seed draw different numbers.
    """

    spec: CodeSpec = CODE_K7_CCSDS
    n_streams: int = 8
    stream_len: int = 4096
    ebn0_db: float = 4.0
    seed: int = 0
    host_id: int = 0
    code: Optional[str] = None
    device: Optional[object] = None

    def key_at(self, step: int) -> int:
        """The seed schedule: batch ``step`` of shard ``host_id`` draws
        from the generator seed ``derive_seed(seed, host_id, step)``, a
        hash of the triple through ``numpy.random.SeedSequence``, so
        distinct (host_id, step) pairs give independent streams and any
        host regenerates any shard."""
        return ch.derive_seed(self.seed, self.host_id, step)

    def shard(self, host_id: int) -> "ChannelStream":
        """This stream re-keyed for shard ``host_id``."""
        return dataclasses.replace(self, host_id=host_id)

    def batch_at(self, step: int):
        dev = resolve_device(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.key_at(step))
        bits = torch.randint(
            0, 2, (self.n_streams, self.stream_len), generator=gen, device=dev
        ).to(torch.int32)
        if self.code is not None:
            from repro_torch.codes import encode_standard, get_code, standard_llrs

            code = get_code(self.code)
            coded = encode_standard(bits, code)
            return bits, standard_llrs(gen, coded, self.ebn0_db, code)
        coded = conv_encode_torch(bits, self.spec)
        rx = ch.awgn(gen, ch.bpsk(coded), self.ebn0_db, self.spec.rate)
        return bits, ch.llr(rx, self.ebn0_db, self.spec.rate)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
