"""Kernel geometry shared by the decoder and the K1 wrapper: the survivor
layout (int8 slots, or 16 slots packed per int32 word), the CUDA block
shape of K1, and the time-parallel eligibility rule.

The reference's VMEM budgets (``FUSED_RING_VMEM_BUDGET`` and friends)
and its 256-frame TPU tile are TPU constants and are not carried over.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "DEFAULT_TIME_TILE",
    "DEFAULT_TRANSFER_TILE",
    "MIN_TIME_PARALLEL_TILES",
    "SLOT_BITS",
    "K1_THREADS",
    "ring_words",
    "ring_dtype",
    "ring_auto_packed",
    "check_packable",
    "pack_slots",
    "k1_block_frames",
    "pick_time_tile",
    "default_transfer_tile",
    "pick_transfer_tile",
    "time_parallel_plan",
]

DEFAULT_TIME_TILE = 32

# time-parallel decode: target steps per transfer-matrix tile, and the
# tile count below which a matrix scan has nothing to parallelize
DEFAULT_TRANSFER_TILE = 64
MIN_TIME_PARALLEL_TILES = 4

# slot width in bits per radix R = 2^rho
SLOT_BITS = {2: 1, 4: 2, 8: 3, 16: 4}

# threads per K1 block: one thread per (frame, state) pair, so a block
# holds K1_THREADS // S frames
K1_THREADS = 256


def ring_words(n_states: int, pack_survivors: bool) -> int:
    """Last-axis width of a survivor entry: 16 slots per int32 word when
    packed, else one int8 per state."""
    return n_states // 16 if pack_survivors else n_states


def ring_dtype(pack_survivors: bool) -> torch.dtype:
    return torch.int32 if pack_survivors else torch.int8


def ring_auto_packed(n_states: int, pack_survivors: bool) -> bool:
    """The streaming ring packs whenever the state count allows, and
    always when explicitly requested."""
    return pack_survivors or n_states % 16 == 0


def check_packable(n_states: int, n_slots: int) -> None:
    """Raise unless 16 slots of this radix fit one int32 word and the
    states split into whole words.

    The reference packs 16 slots per word at any radix, which needs 48
    bits at R = 8 and corrupts the survivors for rho >= 3; the port
    refuses those shapes instead.
    """
    if n_states % 16:
        raise ValueError(
            f"pack_survivors requires n_states % 16 == 0, got {n_states}"
        )
    if 16 * SLOT_BITS[n_slots] > 32:
        raise ValueError(
            f"pack_survivors needs 16 slots of {SLOT_BITS[n_slots]} bits "
            f"in one int32 word (rho <= 2); got {n_slots} slots"
        )


def pack_slots(phi: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(..., S) slot indices -> (..., S//16) int32, slot i of a group at
    bits [b*i, b*(i+1)), b = SLOT_BITS[n_slots]; bit 31 is the sign bit,
    as in the reference's wrapping int32 sum."""
    S = phi.shape[-1]
    check_packable(S, n_slots)
    shifts = SLOT_BITS[n_slots] * torch.arange(16, device=phi.device)
    grp = phi.reshape(*phi.shape[:-1], S // 16, 16).to(torch.int64)
    word = (grp << shifts).sum(dim=-1)
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def k1_block_frames(n_states: int) -> int:
    """Frames per K1 block (one thread per (frame, state) pair)."""
    if n_states > 1024:
        raise ValueError(f"K1 supports at most 1024 states, got {n_states}")
    return max(1, K1_THREADS // n_states)


def pick_time_tile(d_steps: int, t_steps: int, target=None) -> int:
    """Largest time tile <= ``target`` dividing both ``d_steps`` and
    ``t_steps``.  Always >= 1."""
    target = target or DEFAULT_TIME_TILE
    g = math.gcd(int(d_steps), int(t_steps))
    best = 1
    c = 1
    while c * c <= g:
        if g % c == 0:
            if c <= target:
                best = max(best, c)
            if g // c <= target:
                best = max(best, g // c)
        c += 1
    return best


def default_transfer_tile(t_steps: int) -> int:
    """Shape-derived transfer-tile target ~ sqrt(T')."""
    target = 1
    while target * target < t_steps:
        target *= 2
    return max(DEFAULT_TRANSFER_TILE, min(target, 2048))


def pick_transfer_tile(t_steps: int, target=None) -> int:
    """Largest divisor of ``t_steps`` <= ``target`` (default: the
    sqrt-scaled ``default_transfer_tile``).  Always >= 1."""
    return pick_time_tile(
        t_steps, t_steps, target or default_transfer_tile(t_steps)
    )


def time_parallel_plan(
    n_frames: int,
    t_steps: int,
    n_states: int,
    time_parallel=None,
    transfer_tile=None,
    underfill_rows=None,
):
    """Time-parallel eligibility, as in the reference: the transfer tile
    (in radix steps) to decode with, or None to stay on the sequential
    scan.

    ``time_parallel=False`` forces sequential; ``True`` engages whenever
    a usable tile grid exists; ``None`` engages only when
    ``n_frames * n_states`` fits ``underfill_rows`` (default: the
    device's budget, ``backend.device_underfill_rows``).
    """
    if time_parallel is False:
        return None
    if t_steps <= 0 or n_frames <= 0:
        return None
    tt = pick_transfer_tile(t_steps, transfer_tile)
    if tt < 2 or t_steps // tt < MIN_TIME_PARALLEL_TILES:
        return None
    if time_parallel:
        return tt
    if underfill_rows is None:
        from .backend import device_underfill_rows

        underfill_rows = device_underfill_rows()
    return tt if n_frames * n_states <= underfill_rows else None
