"""End-to-end standard-code pipeline (paper Fig. 12 generalized): bits
-> encode (zero-tail or tail-biting) -> puncture -> BPSK + AWGN -> LLR
-> depuncture-aware ``ViterbiDecoder`` decode -> BER.

Eb/N0 is calibrated against the EFFECTIVE rate (puncturing raises the
rate, so fewer coded bits share the same information energy).

Noise comes from ``torch.Generator``s, one per draw.  ``point_key`` and
``batch_keys`` give their seeds: stable across processes, and batch b's
seed depends on (seed, code, Eb/N0, b) only, not on which shard draws
it nor on how many batches there are.  They cannot reproduce the
reference's ``jax.random`` streams, and a CPU generator and a CUDA
generator draw different numbers from one seed.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Tuple

import torch

from repro_torch.core import channel as ch
from repro_torch.core.ber import BerPoint
from repro_torch.core.encoder import conv_encode_torch
# the Fig. 12 batch generator lives in data.pipeline; re-exported here
# because it is the standard-codes simulation front end
from repro_torch.data.pipeline import ChannelStream  # noqa: F401

from .puncture import puncture
from .registry import StandardCode, get_code

__all__ = [
    "ChannelStream",
    "tx_frames",
    "encode_standard",
    "standard_llrs",
    "measure_standard_ber",
    "point_key",
    "batch_keys",
    "sim_frame_batch",
    "count_errors",
]


def tx_frames(bits, code: StandardCode, rho: int = 2) -> torch.Tensor:
    """Message bits -> transmit bits: zero-terminated codes get the k-1
    zero flush tail, rounded up to a rho multiple so a final-state pin
    stays legal; tail-biting frames transmit as they are (no tail)."""
    bits = torch.as_tensor(bits).to(torch.int32)
    if code.termination != "zero":
        return bits
    tail_len = code.spec.k - 1
    tail_len += (-(bits.shape[-1] + tail_len)) % rho
    pad = bits.new_zeros(bits.shape[:-1] + (tail_len,))
    return torch.cat([bits, pad], dim=-1)


def encode_standard(bits, code: StandardCode) -> torch.Tensor:
    """(..., n) message bits -> transmitted coded bits, on the bits'
    device.

    Zero-terminated codes assume the tail is already part of ``bits``
    (``tx_frames``); tail-biting codes need no tail.  Returns (..., n,
    beta) without puncturing, (..., Lp) with.
    """
    coded = conv_encode_torch(
        bits, code.spec, tail_bite=(code.termination == "tailbiting")
    )
    if code.puncture is None:
        return coded
    return puncture(coded, code.puncture)


def standard_llrs(
    generator: torch.Generator, coded, ebn0_db: float, code: StandardCode
) -> torch.Tensor:
    """BPSK + AWGN + LLR formation at the code's EFFECTIVE rate; the
    noise is drawn from ``generator``, which lives on ``coded``'s
    device."""
    rx = ch.awgn(generator, ch.bpsk(coded), ebn0_db, code.rate)
    return ch.llr(rx, ebn0_db, code.rate)


# ---------------------------------------------------------------------------
# Monte-Carlo farm batches
# ---------------------------------------------------------------------------

def _point_entropy(seed: int, code_name: str, ebn0_db: float):
    return [
        seed,
        zlib.crc32(code_name.encode()) & 0x7FFFFFFF,
        int(round(ebn0_db * 1000)) & 0x7FFFFFFF,
    ]


def point_key(seed: int, code_name: str, ebn0_db: float) -> int:
    """Generator seed of one (code, Eb/N0) grid point: a
    ``numpy.random.SeedSequence`` over the seed, a crc32 of the code name
    (stable across processes, unlike ``hash``) and the Eb/N0 in milli-dB.
    Every grid point draws an independent noise process, and every decode
    path of the same point shares it.  It equals batch 0's seed
    (``SeedSequence`` pads its entropy with zeros), so a point measured
    in one batch draws what batch 0 of a farm draws."""
    return ch.derive_seed(*_point_entropy(seed, code_name, ebn0_db))


def batch_keys(
    seed: int, code_name: str, ebn0_db: float, n_batches: int
) -> List[int]:
    """Generator seeds of a grid point's batches: batch ``b``'s is
    ``derive_seed(seed, crc32(code), milli-dB, b)`` whichever shard draws
    it and however many batches there are, so a sharded farm's counts
    equal the single-device counts."""
    base = _point_entropy(seed, code_name, ebn0_db)
    return [ch.derive_seed(*base, b) for b in range(n_batches)]


def sim_frame_batch(
    generator: torch.Generator,
    code: StandardCode,
    n_frames: int,
    n_bits: int,
    ebn0_db: float,
    rho: int = 2,
):
    """One farm batch on ``generator``'s device: (bits (F, n_bits) int32,
    llrs) through the standard tx chain: message bits -> tail
    (zero-terminated codes, rho-aligned) -> encode -> puncture -> BPSK +
    AWGN + LLR at the EFFECTIVE rate.  ``llrs`` is (F, n_tx, beta) shaped
    stages, or the serial kept stream (F, Lp) for punctured codes."""
    dev = generator.device
    bits = torch.randint(
        0, 2, (n_frames, n_bits), generator=generator, device=dev
    ).to(torch.int32)
    coded = encode_standard(tx_frames(bits, code, rho=rho), code)
    return bits, standard_llrs(generator, coded, ebn0_db, code)


def count_errors(decoded, bits) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bit_errors, frame_errors) int32 of a decoded batch against the
    true message bits; ``decoded`` may carry trailing tail-bit columns,
    only the first ``bits.shape[1]`` are scored."""
    decoded, bits = torch.as_tensor(decoded), torch.as_tensor(bits)
    err = decoded[:, : bits.shape[1]] != bits.to(decoded.device)
    return (
        err.sum(dtype=torch.int32),
        err.any(dim=1).sum(dtype=torch.int32),
    )


def measure_standard_ber(
    code_or_name,
    ebn0_db: float,
    n_bits: int,
    generator: torch.Generator,
    n_frames: int = 16,
    use_kernel: bool = True,
    decoder: Optional[object] = None,
    device=None,
) -> Tuple[BerPoint, object]:
    """One BER point of the code x rate grid: ``n_frames`` frames of
    ``n_bits`` message bits each, drawn on ``generator``'s device and
    decoded through the ``ViterbiDecoder`` front door on ``device`` (None
    is the card) or by ``decoder``.  Returns (BerPoint, decoder) so
    sweeps reuse the tables.  ``use_kernel`` defaults to True, a
    departure from the reference, whose default is False: on the card
    ``use_kernel=False`` runs the plain per-step scan, which the port
    keeps for explicit requests.  On the CPU the kernel wrappers run
    their plain versions."""
    from repro_torch.core.decoder import ViterbiDecoder

    code = code_or_name if isinstance(code_or_name, StandardCode) else (
        get_code(code_or_name)
    )
    if decoder is None:
        decoder = ViterbiDecoder.from_standard(
            code.name, use_kernel=use_kernel, device=device
        )
    dev = generator.device
    bits = torch.randint(
        0, 2, (n_frames, n_bits), generator=generator, device=dev
    ).to(torch.int32)
    coded = encode_standard(tx_frames(bits, code, rho=decoder.rho), code)
    llrs = standard_llrs(generator, coded, ebn0_db, code)
    if code.termination == "zero":
        decoded = decoder.decode_batch(llrs, initial_state=0, final_state=0)
    else:
        decoded = decoder.decode_batch(llrs)
    n_err = int(count_errors(decoded, bits)[0])
    return (
        BerPoint(ebn0_db=ebn0_db, n_bits=n_frames * n_bits, n_errors=n_err),
        decoder,
    )
