"""Tiled streams through the serving step.

The program: ``make_viterbi_serve_step(config_for_standard(code),
mode="tiled", one_pass=True)``, one call a batch of streams: (F, n, beta)
LLRs, or the serial kept stream (F, Lp) of a punctured code, in; (F, n)
int32 bits out.

The reference decodes every window of every stream by the configuration's
``tiled`` geometry and decision rule (``reference.conv.window_decode``),
in float32.  The number compared is ``bits_differing``: the bits of the
sampled outputs that differ from the reference's, over every sample.
"""
from __future__ import annotations

import torch

from portbench import codes
from portbench.reference import conv
from portbench.work import Work, acs_step

CHECKS = ("bits_differing",)


def build(config: dict, traffic: dict, device):
    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.serve.step import make_viterbi_serve_step

    vcfg = config_for_standard(config["registry"])
    return make_viterbi_serve_step(vcfg, mode="tiled", one_pass=True, device=device)


def info_bits(config: dict, traffic: dict, batch) -> int:
    return batch.info.numel()


def reference(config: dict, batch, dtype=torch.float32) -> torch.Tensor:
    tiled = config["tiled"]
    llrs = codes.shaped_llrs(config, batch)
    return conv.window_decode(
        llrs, codes.trellis(config), tiled["frame_len"], tiled["overlap"],
        tiled["depth_steps"], tiled["tile_steps"], dtype=dtype,
    )


def control(config: dict, traffic: dict, batch) -> torch.Tensor:
    """The reference in the program's place, in bfloat16."""
    return reference(config, batch, dtype=torch.bfloat16)


def judge(config: dict, traffic: dict, batches: dict, samples: list) -> dict:
    differing = 0
    for index in sorted({i for i, _ in samples}):
        want = reference(config, batches[index])
        for i, out in samples:
            if i == index:
                differing += codes.count_differing(out, want)
    return {"bits_differing": float(differing)}


def work(config: dict, traffic: dict, batch) -> Work:
    tr = codes.trellis(config)
    F, n = batch.info.shape[0], batch.n_stages
    steps = F * n // tr.rho
    moved = 4 * batch.llrs.numel() + 4 * F * n
    return acs_step(tr).scaled(steps) + Work(0.0, 0.0, float(moved))
