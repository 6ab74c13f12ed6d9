"""Smoke run: one punctured and one tail-biting frame batch through the
kernel path and the plain path.

    PYTHONPATH=src python -m repro_torch.codes.smoke [--device cpu]

Asserts that ``wifi-11a-r34`` (punctured, zero-terminated) and
``lte-tbcc`` (rate-1/3 tail-biting, WAVA) both recover their messages at
6 dB AND decode bit-identically with ``use_kernel`` on and off.  On the
card (the default) the kernel path launches the CUDA kernels; on the CPU
their plain versions run.  The noise is drawn on a CPU generator, so
both devices decode the same LLRs.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.decoder import ViterbiDecoder

from .registry import get_code
from .simulate import encode_standard, standard_llrs, tx_frames


def smoke_one(
    name: str, n_bits: int = 512, ebn0_db: float = 6.0, device=None
) -> None:
    code = get_code(name)
    gen = torch.Generator().manual_seed(len(name))
    bits = torch.randint(0, 2, (2, n_bits), generator=gen)
    llrs = standard_llrs(
        gen, encode_standard(tx_frames(bits, code), code), ebn0_db, code
    )
    plain = ViterbiDecoder.from_standard(
        name, use_kernel=False, device=device
    ).decode_batch(llrs)
    ker = ViterbiDecoder.from_standard(
        name, use_kernel=True, device=device
    ).decode_batch(llrs)
    if not torch.equal(plain, ker):
        raise AssertionError(f"{name}: plain and kernel decodes differ")
    n_err = int((plain[:, :n_bits].cpu() != bits).sum())
    if n_err:
        raise AssertionError(f"{name}: {n_err} bit errors at {ebn0_db} dB")
    print(
        f"[smoke] {name} on {plain.device}: rate={code.rate:.2f} "
        f"term={code.termination} {2 * n_bits} bits, 0 errors, "
        "plain == kernel"
    )


def main(device=None) -> None:
    smoke_one("wifi-11a-r34", device=device)  # punctured rate 3/4
    smoke_one("lte-tbcc", device=device)  # rate-1/3 tail-biting WAVA


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    main(ap.parse_args().device)
