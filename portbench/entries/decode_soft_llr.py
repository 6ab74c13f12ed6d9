"""Zero-terminated frames through the decoder's soft output.

The program: ``ViterbiDecoder.from_standard(code).decode_soft(llrs,
output="llr")`` with its default states (start in state 0, free end):
(F, n, beta) LLRs in, (F, n) float32 per-bit LLRs out, positive for bit 0.

The reference is the log-MAP forward-backward recursion in float64
(``reference.conv.bcjr_llrs``).  The number compared is ``llr_gap``: the
largest absolute difference between an output LLR and the reference's,
over every sampled frame.
"""
from __future__ import annotations

import math

import torch

from portbench import codes
from portbench.reference import conv
from portbench.work import Work, acs_step, combine_step

CHECKS = ("llr_gap",)


def build(config: dict, traffic: dict, device):
    from repro_torch.core.decoder import ViterbiDecoder

    decoder = ViterbiDecoder.from_standard(config["registry"], device=device)

    def step(llrs):
        return decoder.decode_soft(llrs, output="llr")

    return step


def info_bits(config: dict, traffic: dict, batch) -> int:
    """The information bits returned with their LLRs (the zero tail's are
    not information)."""
    return batch.info.numel()


def control(config: dict, traffic: dict, batch) -> torch.Tensor:
    """The reference in the program's place, in bfloat16."""
    return conv.bcjr_llrs(codes.shaped_llrs(config, batch), codes.trellis(config),
                          initial_state=0, dtype=torch.bfloat16)


def judge(config: dict, traffic: dict, batches: dict, samples: list) -> dict:
    indices = sorted({i for i, _ in samples})
    # the sampled batches' frames in one pass of the reference
    want = conv.bcjr_llrs(torch.cat([codes.shaped_llrs(config, batches[i]) for i in indices]),
                          codes.trellis(config), initial_state=0, dtype=torch.float64)
    want = dict(zip(indices, want.to(torch.float64).split(int(traffic["frames"]))))
    worst = 0.0
    for i, out in samples:
        if not isinstance(out, torch.Tensor) or tuple(out.shape) != tuple(want[i].shape):
            return {"llr_gap": float("inf")}
        gap = float((out.to(want[i].device, torch.float64) - want[i]).abs().max())
        worst = max(worst, gap if math.isfinite(gap) else float("inf"))
    return {"llr_gap": worst}


def work(config: dict, traffic: dict, batch) -> Work:
    tr = codes.trellis(config)
    F, n = batch.info.shape[0], batch.n_stages
    per_step = acs_step(tr, "logprob") + acs_step(tr, "logprob") + combine_step(tr)
    moved = 4 * batch.llrs.numel() + 4 * F * n
    return per_step.scaled(F * n // tr.rho) + Work(0.0, 0.0, float(moved))
