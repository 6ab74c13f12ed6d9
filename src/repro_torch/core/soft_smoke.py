"""Smoke run: soft-output BCJR on the kernel path and the plain path.

    PYTHONPATH=src python -m repro_torch.core.soft_smoke [--device cpu]

Decodes one 6 dB ``wifi-11a-r34`` frame batch (punctured,
zero-terminated) with ``ViterbiDecoder.decode_soft`` with ``use_kernel``
off and on (K3-LOGPROB on the card, its plain version on the CPU), and
asserts that the signs of the BCJR LLRs equal the hard Viterbi decode on
both.  A tail-biting ``lte-tbcc`` batch exercises the exact circular
BCJR the same way.  The noise is drawn on a CPU generator.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.codes.registry import get_code
from repro_torch.codes.simulate import encode_standard, standard_llrs, tx_frames

from .decoder import ViterbiDecoder


def smoke_one(
    name: str, n_bits: int = 256, ebn0_db: float = 6.0, device=None
) -> None:
    code = get_code(name)
    gen = torch.Generator().manual_seed(len(name))
    bits = torch.randint(0, 2, (2, n_bits), generator=gen)
    llrs = standard_llrs(
        gen, encode_standard(tx_frames(bits, code), code), ebn0_db, code
    )
    hard = ViterbiDecoder.from_standard(name, device=device).decode_batch(llrs)
    for use_kernel in (False, True):
        dec = ViterbiDecoder.from_standard(
            name, use_kernel=use_kernel, device=device
        )
        signs = (dec.decode_soft(llrs, output="llr") < 0).to(torch.int32)
        backend = "kernel" if use_kernel else "plain"
        if signs.shape != hard.shape:
            raise AssertionError(
                f"{name}/{backend}: LLR shape {tuple(signs.shape)} != hard "
                f"{tuple(hard.shape)}"
            )
        n_mis = int((signs != hard).sum())
        if n_mis:
            raise AssertionError(
                f"{name}/{backend}: {n_mis} LLR signs disagree with Viterbi "
                f"at {ebn0_db} dB"
            )
        n_err = int((signs[:, :n_bits].cpu() != bits).sum())
        if n_err:
            raise AssertionError(
                f"{name}/{backend}: {n_err} bit errors at {ebn0_db} dB"
            )
        print(
            f"[soft-smoke] {name} ({backend}) on {signs.device}: "
            f"term={code.termination} {2 * n_bits} bits, "
            "sign(LLR) == viterbi, 0 errors"
        )


def main(device=None) -> None:
    smoke_one("wifi-11a-r34", device=device)  # punctured, open trellis
    smoke_one("lte-tbcc", device=device)  # tail-biting: exact circular BCJR


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(ap.parse_args().device)
