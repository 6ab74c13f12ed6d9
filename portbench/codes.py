"""A configuration's code, as the benchmark reads it from its file."""
from __future__ import annotations

import functools

import torch

from portbench.reference import conv

__all__ = ["polys", "trellis", "shaped_llrs", "count_differing", "registry_mismatch"]


def polys(config: dict) -> tuple:
    """The generators, from the octal strings of the configuration."""
    return tuple(int(g, 8) for g in config["code"]["polys"])


@functools.lru_cache(maxsize=16)
def _trellis(k: int, gens: tuple, rho: int) -> conv.Trellis:
    return conv.Trellis(k, gens, rho)


def trellis(config: dict) -> conv.Trellis:
    return _trellis(config["code"]["k"], polys(config), config["rho"])


def shaped_llrs(config: dict, batch) -> torch.Tensor:
    """The batch's (F, n, beta) LLRs, with zero LLRs where punctured."""
    mask = config["code"]["puncture"]
    if mask is None:
        return batch.llrs
    return conv.depuncture(batch.llrs, mask, batch.n_stages)


def count_differing(out, want: torch.Tensor) -> int:
    """Entries of ``out`` that differ from ``want``; every entry where the
    output is not a tensor of the same shape."""
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != tuple(want.shape):
        return want.numel()
    return int((out.to(want.device, torch.int64) != want.to(torch.int64)).sum())


def registry_mismatch(config: dict) -> list:
    """What differs between the configuration's code and the program's
    registry entry of the same name (an empty list where nothing does)."""
    from repro_torch.codes.registry import get_code

    entry = get_code(config["registry"])
    code = config["code"]
    found = []
    if entry.spec.k != code["k"]:
        found.append(f"k: registry {entry.spec.k}, file {code['k']}")
    if tuple(entry.spec.polys) != polys(config):
        found.append(f"polys: registry {[oct(g) for g in entry.spec.polys]}, "
                     f"file {code['polys']}")
    mask = None if entry.puncture is None else [list(r) for r in entry.puncture.mask]
    if mask != code["puncture"]:
        found.append(f"puncture: registry {mask}, file {code['puncture']}")
    if entry.termination != code["termination"]:
        found.append(f"termination: registry {entry.termination}, file {code['termination']}")
    return found
