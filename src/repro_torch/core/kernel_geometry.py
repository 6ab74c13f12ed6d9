"""Kernel geometry shared by the decoder and the kernel wrappers: the
survivor layout (int8 slots, or 16 slots packed per int32 word), the CUDA
block shapes of K1, K2 and K3 (and the W that K3 can gather from), the
one-pass eligibility rule of the streaming entry points, and the
time-parallel eligibility rule.

The one-pass rule (``one_pass_time_tile``) keeps the reference's numbers
on purpose: it decides whether a chunk takes the one-pass or the two-pass
step, and the two emit different bits wherever survivors have not merged
within the decision depth, so both packages must choose alike on every
shape.  Its ring budget is therefore the reference's dispatch rule, not a
Hopper budget; where K2 actually keeps its ring on the card is
``k2_block_frames``'s business.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "DEFAULT_TIME_TILE",
    "DEFAULT_TRANSFER_TILE",
    "MIN_ONE_PASS_TILE",
    "ONE_PASS_RING_BUDGET",
    "ONE_PASS_RULE_FRAMES",
    "MIN_TIME_PARALLEL_TILES",
    "SLOT_BITS",
    "K1_THREADS",
    "K3_THREADS",
    "K3_MAX_STATES",
    "K3_STAGE_TARGET",
    "SMEM_LIMIT_BYTES",
    "STAGE_STEPS",
    "ring_words",
    "ring_dtype",
    "ring_auto_packed",
    "check_packable",
    "pack_slots",
    "k1_block_frames",
    "k2_smem_bytes",
    "k2_block_frames",
    "k3_rotation_period",
    "k3_stage_steps",
    "k3_in_registers",
    "k3_smem_bytes",
    "k3_block_frames",
    "k3_gather_tables",
    "pick_time_tile",
    "fused_ring_bytes",
    "one_pass_time_tile",
    "default_transfer_tile",
    "pick_transfer_tile",
    "time_parallel_plan",
]

DEFAULT_TIME_TILE = 32

# The reference's one-pass dispatch rule, kept number for number so that
# both packages pick the same path (and so emit the same bits) on every
# shape: a time tile below MIN_ONE_PASS_TILE takes the two-pass step, and
# so does a survivor ring of more than ONE_PASS_RING_BUDGET bytes,
# reckoned at ONE_PASS_RULE_FRAMES frames unless the caller names a frame
# count.  These are not a Hopper budget: K2 places its ring by
# ``k2_block_frames``.
MIN_ONE_PASS_TILE = 8
ONE_PASS_RING_BUDGET = 12 * 2**20
ONE_PASS_RULE_FRAMES = 256

# time-parallel decode: target steps per transfer-matrix tile, and the
# tile count below which a matrix scan has nothing to parallelize
DEFAULT_TRANSFER_TILE = 64
MIN_TIME_PARALLEL_TILES = 4

# slot width in bits per radix R = 2^rho
SLOT_BITS = {2: 1, 4: 2, 8: 3, 16: 4}

# threads per K1 block: one thread per (frame, state) pair, so a block
# holds K1_THREADS // S frames
K1_THREADS = 256

# threads per K3 block (kThreads in csrc/transfer_matrix.cu): one thread
# per (frame, entry row), its S metrics in registers, so a block holds
# K3_THREADS // S frames and S is at most K3_MAX_STATES
K3_THREADS = 128
K3_MAX_STATES = 64
# K3 stages branch metrics about this many steps at a time, rounded up to
# a whole rotation period (kStageTarget in csrc/transfer_matrix.cu)
K3_STAGE_TARGET = 8

# dynamic shared memory one H100 block may opt in to
SMEM_LIMIT_BYTES = 232448
# LLR steps a block stages into shared memory at once (kStageSteps in
# csrc/acs_step.cuh)
STAGE_STEPS = 32


def ring_words(n_states: int, pack_survivors: bool) -> int:
    """Last-axis width of a survivor entry: 16 slots per int32 word when
    packed, else one int8 per state."""
    return n_states // 16 if pack_survivors else n_states


def ring_dtype(pack_survivors: bool) -> torch.dtype:
    return torch.int32 if pack_survivors else torch.int8


def ring_auto_packed(
    n_states: int, pack_survivors: bool, n_slots: int = 4
) -> bool:
    """The streaming ring packs when explicitly requested, and otherwise
    whenever the state count and the radix allow.  The reference packs
    at any radix, which corrupts the ring for rho >= 3 (16 slots of 3
    bits do not fit a word); the port keeps an int8 ring there."""
    return pack_survivors or (
        n_states % 16 == 0 and 16 * SLOT_BITS[n_slots] <= 32
    )


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


def k2_smem_bytes(
    llr_block: int,
    n_states: int,
    n_slots: int,
    block_frames: int,
    ring_bytes_per_frame: int = 0,
) -> int:
    """Dynamic shared memory of one K2 block, in bytes: W, the staged LLR
    steps, the matmul-rounded and the carried metrics, the renorm
    partial maxima (16-byte aligned), then the block's survivor rings
    when they live in shared memory (``ring_bytes_per_frame`` > 0).
    The wrapper launches K2 with this many bytes; the launcher refuses a
    count that does not hold the kernel's layout."""
    S, B, BF = n_states, llr_block, block_frames
    warps_per_frame = S // 32 if S >= 32 else 1
    floats = (
        (B + S) * S * n_slots
        + STAGE_STEPS * BF * B
        + 2 * BF * S
        + BF * warps_per_frame
    )
    head = -(-floats * 4 // 16) * 16
    return head + BF * ring_bytes_per_frame


def k2_block_frames(
    n_states: int,
    llr_block: int,
    n_slots: int,
    ring_bytes_per_frame: int,
    smem_limit: int = SMEM_LIMIT_BYTES,
):
    """(frames per K2 block, ring in shared memory?).

    One thread per (frame, state), at most K1's 256 threads, and a whole
    number of warps.  The most frames whose rings fit in shared memory
    beside W and the staged LLRs; where not even the fewest fit, the
    rings go to a scratch buffer in device memory and the block takes
    K1's frame count."""
    bf_max = k1_block_frames(n_states)
    unit = max(1, 32 // n_states)  # frames that fill one warp
    for bf in range(bf_max, 0, -unit):
        if k2_smem_bytes(
            llr_block, n_states, n_slots, bf, ring_bytes_per_frame
        ) <= smem_limit:
            return bf, True
    return bf_max, False


def k3_rotation_period(n_states: int, n_slots: int) -> int:
    """Steps after which K3's register map repeats: a radix-R step moves
    logical state x to the register of x rotated left by rho of its
    k-1 bits, so (k-1) / gcd(k-1, rho) steps (S = 2^(k-1), R = 2^rho)."""
    bits = n_states.bit_length() - 1
    rho = n_slots.bit_length() - 1
    return bits // math.gcd(bits, rho)


def k3_stage_steps(n_states: int, n_slots: int) -> int:
    """Steps of branch metrics a K3 block stages at once: about
    ``K3_STAGE_TARGET``, a whole number of rotation periods."""
    p = k3_rotation_period(n_states, n_slots)
    return p * -(-K3_STAGE_TARGET // p)


def k3_block_frames(n_states: int) -> int:
    """Frames per K3 block: one thread per (frame, entry row), so
    ``K3_THREADS // S``.  A row's S metrics live in its thread's
    registers, so S above ``K3_MAX_STATES`` raises ``ValueError``, as the
    reference raises on what its VMEM cannot hold.  Frames are
    independent, so the block shape changes the layout, never the
    bits."""
    if n_states > K3_MAX_STATES:
        raise ValueError(
            f"K3 keeps an entry row's metrics in one thread's registers: "
            f"{n_states} states do not fit (at most {K3_MAX_STATES})"
        )
    return max(1, K3_THREADS // n_states)


def k3_in_registers(n_states: int, n_slots: int) -> bool:
    """Whether K3 keeps a row's metrics in registers (S in {16, 64}, every
    code of the registry, at R <= 8), or in shared memory (every other
    shape)."""
    return n_states in (16, 64) and n_slots <= 8


def k3_smem_bytes(n_states: int, n_slots: int) -> int:
    """Dynamic shared memory of one K3 block, in bytes: the branch-metric
    table twice (stage s is read while stage s+1 is written), each
    ``k3_stage_steps`` steps x BF frames x S*R floats; the K3_THREADS
    rows at a stride of S + 1 floats where they are not in registers
    (``k3_in_registers``); then the per-warp maxima of the final shift.
    The wrapper launches K3 with this many bytes; the launcher refuses
    any other count."""
    S, R = n_states, n_slots
    bf = k3_block_frames(S)
    warps_per_frame = S // 32 if S >= 32 else 1
    rows = 0 if k3_in_registers(S, R) else K3_THREADS * (S + 1)
    floats = 2 * k3_stage_steps(S, R) * bf * S * R + rows + bf * warps_per_frame
    return floats * 4


def k3_gather_tables(w: torch.Tensor, llr_block: int, n_states: int,
                     n_slots: int):
    """(theta (B, S*R), pred (S, R) int64): W's LLR half, which K3
    takes in place of W, and the predecessor of each (state, slot) as W's
    metric half routes it.

    K3 forms each potential as a branch metric plus the one predecessor
    metric, so it takes only a W whose metric half is the 0/1 one-hot of
    the shift register, ``pred(j, r) = ((j & mask) << rho) | r`` with
    ``mask = 2^(k-1-rho) - 1`` and S = 2^(k-1), as
    ``trellis.build_acs_tables`` makes it.  Raises ``ValueError`` on any
    other: a shape that is not (B + S, S * R), an R that is not a radix
    of S, a column that is not exactly one 1.0 among 0.0s, or a one in
    another row than the rule's.  Reads W on the host."""
    S, R, B = n_states, n_slots, llr_block
    if R not in SLOT_BITS or S < R or S & (S - 1):
        raise ValueError(
            f"K3 needs S = 2^(k-1) states and R = 2^rho <= S slots; got "
            f"S={S}, R={R}"
        )
    if tuple(w.shape) != (B + S, S * R):
        raise ValueError(
            f"K3: W has shape {tuple(w.shape)}, expected {(B + S, S * R)}"
        )
    rho = SLOT_BITS[R]
    mask = (1 << (S.bit_length() - 1 - rho)) - 1
    routing = w[B:].detach().to("cpu", torch.float32)
    rows = routing.argmax(dim=0)
    onehot = torch.zeros_like(routing)
    onehot[rows, torch.arange(S * R)] = 1.0
    if not torch.equal(routing, onehot):
        raise ValueError(
            "K3: W's metric half is not one 1.0 per column among 0.0s, so a "
            "potential is not one predecessor metric plus a branch metric"
        )
    j = torch.arange(S)[:, None]
    want = ((j & mask) << rho) | torch.arange(R)[None, :]
    pred = rows.view(S, R)
    if not torch.equal(pred, want):
        raise ValueError(
            "K3: W's metric half routes other predecessors than the shift "
            "register's ((j & mask) << rho) | r"
        )
    return w[:B], pred


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


def fused_ring_bytes(
    depth_steps: int,
    time_tile: int,
    block_frames: int,
    n_states: int,
    pack_survivors: bool,
) -> int:
    """Bytes of a one-pass survivor ring of ``depth_steps + time_tile``
    steps over ``block_frames`` frames (the reference's
    ``fused_ring_vmem_bytes``)."""
    itemsize = torch.iinfo(ring_dtype(pack_survivors)).bits // 8
    return (
        (depth_steps + time_tile)
        * block_frames
        * ring_words(n_states, pack_survivors)
        * itemsize
    )


def one_pass_time_tile(
    d_steps: int,
    t_steps: int,
    n_states: int,
    ring_packed: bool,
    time_tile=None,
    block_frames=None,
):
    """The one-pass eligibility rule of every streaming entry point: the
    time tile to launch K2 with, or None when the chunk takes the
    two-pass step — packing impossible, no common tile of at least
    ``MIN_ONE_PASS_TILE`` steps (or of the whole depth or chunk), or a
    ring beyond ``ONE_PASS_RING_BUDGET`` at ``block_frames`` (default
    ``ONE_PASS_RULE_FRAMES``) frames.  The reference's rule, unchanged."""
    if d_steps <= 0 or t_steps <= 0:
        return None
    if ring_packed and n_states % 16:
        return None
    tt = pick_time_tile(d_steps, t_steps, time_tile)
    if tt < min(MIN_ONE_PASS_TILE, d_steps, t_steps):
        return None
    bf = block_frames or ONE_PASS_RULE_FRAMES
    if (
        fused_ring_bytes(d_steps, tt, bf, n_states, ring_packed)
        > ONE_PASS_RING_BUDGET
    ):
        return None
    return tt


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
    time_parallel,
    transfer_tile,
    underfill_rows: int,
):
    """Time-parallel eligibility, as in the reference: the transfer tile
    (in radix steps) to decode with, or None to stay on the sequential
    scan.

    ``time_parallel=False`` forces sequential; ``True`` engages whenever
    a usable tile grid exists; ``None`` engages only when
    ``n_frames * n_states`` fits ``underfill_rows``, the budget of the
    device the caller decodes on (``backend.device_underfill_rows``).
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
    return tt if n_frames * n_states <= underfill_rows else None
