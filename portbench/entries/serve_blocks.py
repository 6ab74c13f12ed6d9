"""Tail-biting blocks through the serving step's batch mode.

The program: ``make_viterbi_serve_step(config_for_standard(code),
mode="batch")``, one call a batch of blocks: (F, n, beta) LLRs in, (F, n)
int32 bits out, through ``decode_tailbiting`` (WAVA).

Two plain references judge it (``reference.tailbiting``), both in
float32, over every frame of every sample:

- ``bits_differing``: the bits that differ from the maximum-likelihood
  decode of the circular trellis.  WAVA checks only its best end state's
  path, and departs from the ML decode on the frames where the best path
  of the open trellis is not circular; the limit allows those
  departures.
- ``wava_bits_differing``: the bits that differ from the reference's
  wrap-around decode with the program's circulations, the same
  algorithm as the program's.

The control is that wrap-around decode in bfloat16.
"""
from __future__ import annotations

import torch

from portbench import codes
from portbench.reference import tailbiting
from portbench.work import Work, acs_step

CHECKS = ("bits_differing", "wava_bits_differing")


def build(config: dict, traffic: dict, device):
    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.serve.step import make_viterbi_serve_step

    vcfg = config_for_standard(config["registry"])
    return make_viterbi_serve_step(vcfg, mode="batch", device=device)


def info_bits(config: dict, traffic: dict, batch) -> int:
    return batch.info.numel()


def control(config: dict, traffic: dict, batch) -> torch.Tensor:
    """The wrap-around reference in the program's place, in bfloat16."""
    return tailbiting.wava_decode(codes.shaped_llrs(config, batch), codes.trellis(config),
                                  config["wava_circulations"], dtype=torch.bfloat16)


def judge(config: dict, traffic: dict, batches: dict, samples: list) -> dict:
    tr = codes.trellis(config)
    differing = {name: 0 for name in CHECKS}
    for index in sorted({i for i, _ in samples}):
        llrs = codes.shaped_llrs(config, batches[index])
        want = {"bits_differing": tailbiting.ml_decode(llrs, tr),
                "wava_bits_differing": tailbiting.wava_decode(
                    llrs, tr, config["wava_circulations"])}
        for i, out in samples:
            if i == index:
                for name in CHECKS:
                    differing[name] += codes.count_differing(out, want[name])
    return {name: float(v) for name, v in differing.items()}


def work(config: dict, traffic: dict, batch) -> Work:
    """One ACS pass over the circular trellis, each LLR read once and each
    bit written once: WAVA's further circulations are not counted."""
    tr = codes.trellis(config)
    F, n = batch.info.shape[0], batch.n_stages
    moved = 4 * batch.llrs.numel() + 4 * F * n
    return acs_step(tr).scaled(F * n // tr.rho) + Work(0.0, 0.0, float(moved))
