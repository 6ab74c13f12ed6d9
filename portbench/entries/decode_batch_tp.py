"""Zero-terminated frames through the decoder's time-parallel batch path.

The program: ``ViterbiDecoder.from_standard(code).decode_batch(llrs,
time_parallel=True)`` with its default states (start in state 0, any end
state): (F, n, beta) LLRs in, (F, n) int32 bits out.

The reference is the full-trellis maximum-likelihood decode in float64
(``reference.conv.path_gap``).  The number compared is ``path_gap``: over
every sampled frame, how far the metric of the path the program returned
lies below the best path's metric.  A sound decode returns a best path,
or one that ties it to within float32 rounding of the program's own
arithmetic.
"""
from __future__ import annotations

import torch

from portbench import codes
from portbench.reference import conv
from portbench.work import Work, acs_step

CHECKS = ("path_gap",)


def build(config: dict, traffic: dict, device):
    from repro_torch.core.decoder import ViterbiDecoder

    decoder = ViterbiDecoder.from_standard(config["registry"], device=device)

    def step(llrs):
        return decoder.decode_batch(llrs, time_parallel=True)

    return step


def info_bits(config: dict, traffic: dict, batch) -> int:
    return batch.info.numel()


def control(config: dict, traffic: dict, batch) -> torch.Tensor:
    """The reference in the program's place, in bfloat16."""
    return conv.viterbi_decode(codes.shaped_llrs(config, batch), codes.trellis(config),
                               initial_state=0, dtype=torch.bfloat16)


def judge(config: dict, traffic: dict, batches: dict, samples: list) -> dict:
    llrs, paths = [], []
    for i, out in samples:
        batch = batches[i]
        shape = (batch.info.shape[0], batch.n_stages)
        if (not isinstance(out, torch.Tensor) or tuple(out.shape) != shape
                or bool(((out != 0) & (out != 1)).any())):
            return {"path_gap": float("inf")}
        llrs.append(codes.shaped_llrs(config, batch))
        paths.append(out.to(batch.llrs.device))
    # every sampled frame in one pass of the reference
    gap = conv.path_gap(torch.cat(llrs), torch.cat(paths), codes.trellis(config),
                        config["code"]["k"])
    return {"path_gap": float(gap.max())}


def work(config: dict, traffic: dict, batch) -> Work:
    tr = codes.trellis(config)
    F, n = batch.info.shape[0], batch.n_stages
    moved = 4 * batch.llrs.numel() + 4 * F * n
    return acs_step(tr).scaled(F * n // tr.rho) + Work(0.0, 0.0, float(moved))
