"""Data pipelines.

``ChannelStream`` is the paper's pipeline (Fig. 12): random bits ->
convolutional encoder -> BPSK + AWGN -> LLR frames, for the Viterbi
decoder service and BER measurements.  (The reference's ``TokenStream``,
synthetic LM batches, belongs to the LM testbed and is not ported yet.)

Determinism: batch ``i`` of host ``h`` is a pure function of
(seed, h, i), so restarts resume exactly and any host can regenerate any
shard.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import channel as ch
from repro_torch.core.backend import resolve_device
from repro_torch.core.encoder import conv_encode_torch
from repro_torch.core.trellis import CODE_K7_CCSDS, CodeSpec

__all__ = ["ChannelStream"]


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
