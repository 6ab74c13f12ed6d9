"""The one traffic generator: seeded batches of channel LLRs on the device.

A traffic file (``traffic/<name>.json``) gives the batch's shape and the
channel; a configuration file (``configs/<name>.json``) gives the code.
Every batch is drawn in a few large calls on the device from a
``torch.Generator`` seeded by (run seed, pool index): random information
bits, the convolutional encoder (``reference.conv.encode``) started as
the configuration's ``termination`` says, puncturing to the serial kept
stream where the configuration punctures, BPSK (bit 0 -> +1), white
Gaussian noise at the traffic's Eb/N0 for the code's rate, and the LLR
2y / sigma^2.  The same seed gives the same batches; every seed gives
the same sizes.

Terminations: ``zero`` starts the encoder in state 0, and with the
traffic's ``zero_tail`` ends the frame with k - 1 zero bits (a stream has
no tail); ``tailbiting`` starts it in the state its last k - 1 bits
leave, so it ends where it began.  Any other value raises.  A decode
entry that needs inputs this generator does not make defines its own
``draw`` with the same signature (``harness`` prefers it).
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from portbench.reference import conv

__all__ = ["Batch", "TERMINATIONS", "stages", "code_rate", "sub_seed", "draw"]


@dataclasses.dataclass
class Batch:
    info: torch.Tensor  # (F, n_info) uint8 information bits
    llrs: torch.Tensor  # what the entry takes: (F, n, beta), or (F, Lp) kept
    n_stages: int
    n_info: int


def stages(config: dict, traffic: dict) -> int:
    """Trellis stages of one frame or stream."""
    if "stages" in traffic:
        return int(traffic["stages"])
    mask = config["code"]["puncture"]
    if mask is None:
        raise ValueError("kept_llrs needs a punctured code")
    kept, period = sum(map(sum, mask)), len(mask)
    if traffic["kept_llrs"] % kept:
        raise ValueError(f"{traffic['kept_llrs']} kept LLRs are not whole periods")
    return traffic["kept_llrs"] // kept * period


def code_rate(config: dict) -> Fraction:
    code = config["code"]
    mask = code["puncture"]
    if mask is None:
        return Fraction(1, len(code["polys"]))
    return Fraction(len(mask), sum(map(sum, mask)))


def sub_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for pool entry ``index`` of run ``seed``
    (any whole number, large or negative)."""
    entropy = [abs(int(seed)), int(seed < 0), int(index)]
    hi, lo = np.random.SeedSequence(entropy).generate_state(2)
    return int(hi) << 31 | int(lo) >> 1


TERMINATIONS = ("zero", "tailbiting")


def draw(config: dict, traffic: dict, seed: int, index: int, device) -> Batch:
    code = config["code"]
    k, polys = code["k"], [int(g, 8) for g in code["polys"]]
    termination = code["termination"]
    if termination not in TERMINATIONS:
        raise ValueError(f"termination {termination!r} is not one of {TERMINATIONS}")
    if termination == "tailbiting" and traffic.get("zero_tail"):
        raise ValueError("a tail-biting code has no zero tail")
    F, n = int(traffic["frames"]), stages(config, traffic)
    n_info = n - (k - 1) if traffic.get("zero_tail") else n
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, index))
    info = torch.randint(0, 2, (F, n_info), generator=gen, device=device, dtype=torch.uint8)
    bits = torch.nn.functional.pad(info, (0, n - n_info))
    coded = conv.encode(bits, k, polys, tail_biting=termination == "tailbiting")
    if code["puncture"] is not None:
        coded = conv.puncture(coded, code["puncture"])
    rate = float(code_rate(config))
    sigma = math.sqrt(1.0 / (2.0 * rate * 10.0 ** (float(traffic["ebn0_db"]) / 10.0)))
    noise = torch.randn(coded.shape, generator=gen, device=device, dtype=torch.float32)
    y = (1.0 - 2.0 * coded.to(torch.float32)) + sigma * noise
    return Batch(info=info, llrs=(2.0 / sigma ** 2) * y, n_stages=n, n_info=n_info)
