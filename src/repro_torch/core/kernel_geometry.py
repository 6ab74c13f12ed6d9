"""Kernel geometry shared by the decoder and the kernel wrappers: the
survivor layout (int8 slots, or 16 slots packed per int32 word), the CUDA
block shapes and shared-memory layouts of K1, K2 and K3, the W they can
gather from (``gather_tables``), the one-pass eligibility rule of the
streaming entry points, the time-parallel eligibility rule, and the
serving engine's cell rungs.

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
    "GATHER_WARPS",
    "GATHER_GROUP_BUDGET",
    "K3_THREADS",
    "K3_MAX_STATES",
    "K3_STAGE_TARGET",
    "SMEM_LIMIT_BYTES",
    "H100_SMS",
    "SMEM_PER_SM_BYTES",
    "SMEM_BLOCK_RESERVE",
    "K2_MIN_BLOCKS",
    "STAGE_STEPS",
    "ring_words",
    "ring_dtype",
    "ring_auto_packed",
    "check_packable",
    "pack_slots",
    "gather_states_per_thread",
    "gather_frame_threads",
    "gather_group_frames",
    "gather_block_shape",
    "gather_group_bytes",
    "gather_stage_steps",
    "k1_smem_bytes",
    "k2_frame_bytes",
    "k2_smem_bytes",
    "k2_waves",
    "k2_block_frames",
    "k3_rotation_period",
    "k3_stage_steps",
    "k3_in_registers",
    "k3_smem_bytes",
    "k3_block_frames",
    "gather_tables",
    "pick_time_tile",
    "fused_ring_bytes",
    "one_pass_time_tile",
    "default_transfer_tile",
    "pick_transfer_tile",
    "time_parallel_plan",
    "ENGINE_MIN_CELL",
    "pick_cell_length",
    "pick_cell_frames",
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

# K1 (both semirings) and K2, the gathered step of csrc/acs_step.cuh: a
# frame's S states over S / NQ threads (NQ = 2 from S = 64), GATHER_WARPS
# warps a block (kGatherWarps) where a frame fits in a warp, else a block
# of one frame of S / 2 threads.  A stage of LLR steps is cut short where
# one frame group's staging would pass GATHER_GROUP_BUDGET bytes.
GATHER_WARPS = 4
GATHER_GROUP_BUDGET = 48 * 1024

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
# an H100 SXM's SMs, the shared memory of one SM, and what each block
# resident on it reserves of that
H100_SMS = 132
SMEM_PER_SM_BYTES = 233472
SMEM_BLOCK_RESERVE = 1024
# the blocks an SM is sure to hold by K2's __launch_bounds__
# (csrc/acs_decode_fused.cu): 3 where a frame fits in a warp, else 1
K2_MIN_BLOCKS = 3
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


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def gather_states_per_thread(n_states: int) -> int:
    """States a thread of K1 or K2 owns: 1 where S <= 32, else 2 (t and t
    + S/2, which share their R predecessors), at both of K1's semirings:
    one state a lane at S = 64 (a frame over two warps, half the expf a
    lane) made K1-LOGPROB 1.4-1.5x slower on an H100 at 64 and at 512
    frames (``tools/k12_variants.py``)."""
    return 2 if n_states >= 64 else 1


def gather_frame_threads(n_states: int) -> int:
    """Threads a frame of K1 or K2: S / NQ."""
    if n_states > 1024:
        raise ValueError(f"K1 and K2 support at most 1024 states, got {n_states}")
    return n_states // gather_states_per_thread(n_states)


def gather_group_frames(n_states: int) -> int:
    """Frames that share a barrier: those of one warp (32 / tpf), or the
    one frame of a block where a frame spans warps (S >= 128)."""
    tpf = gather_frame_threads(n_states)
    return 32 // tpf if tpf <= 32 else 1


def gather_block_shape(n_states: int):
    """(frames, frame threads) of a K1 block, and of a K2 block at most
    (which adds a walk warp): ``GATHER_WARPS`` warps of frames where a
    frame fits in a warp; (1, S / 2) where it does not."""
    tpf = gather_frame_threads(n_states)
    if tpf > 32:
        return 1, tpf
    return GATHER_WARPS * (32 // tpf), 32 * GATHER_WARPS


def gather_group_bytes(n_states: int, llr_block: int, n_cols: int,
                       stage_steps: int, track: bool) -> int:
    """Shared memory of one frame group (``GroupSmem`` in
    csrc/acs_step.cuh), 16-byte aligned parts: staged LLRs and branch
    metrics of a stage (``n_cols`` distinct columns of Theta), the metrics
    double-buffered, with ``track`` (K2) the origins of the tile's paths
    double-buffered as u16, the staged survivors, 32 words of reductions."""
    S, B, SS = n_states, llr_block, stage_steps
    gf = gather_group_frames(S)
    bm = _align16(SS * gf * B * 4)
    x = _align16(bm + SS * gf * n_cols * 4)
    orig = _align16(x + 2 * gf * S * 4)
    phi = _align16(orig + (2 * gf * S * 2 if track else 0))
    red = _align16(phi + SS * gf * S)
    return _align16(red + 32 * 4)


def gather_stage_steps(n_states: int, llr_block: int, n_cols: int,
                       track: bool) -> int:
    """LLR steps a frame group stages at once: ``STAGE_STEPS``, halved
    while its region passes ``GATHER_GROUP_BUDGET`` (down to 1)."""
    ss = STAGE_STEPS
    while ss > 1 and gather_group_bytes(
        n_states, llr_block, n_cols, ss, track
    ) > GATHER_GROUP_BUDGET:
        ss //= 2
    return ss


def k1_smem_bytes(n_states: int, llr_block: int, n_cols: int) -> int:
    """Dynamic shared memory of one K1 block: its frame groups' regions at
    ``gather_stage_steps``; the launcher refuses another count."""
    S = n_states
    groups = GATHER_WARPS if gather_frame_threads(S) <= 32 else 1
    ss = gather_stage_steps(S, llr_block, n_cols, False)
    return groups * gather_group_bytes(S, llr_block, n_cols, ss, False)


def k2_frame_bytes(n_states: int, depth: int, tile: int, packed: bool) -> int:
    """One frame's K2 ring of depth + 2 tiles of steps (S/16 int32 words,
    or S int8, a step: the lookahead, the oldest tile, and one more, which
    the next tile's ACS writes while the walk warp walks this one) and its
    tile maps (depth / tile + 2 tiles x S states, u8 where S <= 256, else
    u16), each 16-byte aligned."""
    S = n_states
    tiles = depth // tile + 2
    ring = _align16(tiles * tile * (S // 16 * 4 if packed else S))
    maps = _align16(tiles * S * (1 if S <= 256 else 2))
    return ring + maps


def k2_smem_bytes(n_states: int, llr_block: int, n_cols: int, depth: int,
                  tile: int, packed: bool, block_frames: int,
                  rings_in_smem: bool) -> int:
    """Dynamic shared memory of one K2 block of ``block_frames`` frames:
    its frame groups' regions, the frames' start states (an int each,
    which the walk warp reads; two buffers by the tile's parity), then the
    frames' rings and maps when they live in shared memory.  The launcher
    refuses another count."""
    S = n_states
    gf = gather_group_frames(S)
    groups = block_frames // gf if gather_frame_threads(S) <= 32 else 1
    ss = gather_stage_steps(S, llr_block, n_cols, True)
    head = (groups * gather_group_bytes(S, llr_block, n_cols, ss, True)
            + _align16(8 * block_frames))
    rings = block_frames * k2_frame_bytes(S, depth, tile, packed)
    return head + (rings if rings_in_smem else 0)


def k2_waves(n_frames: int, n_states: int, block_frames: int,
             smem_bytes: int, n_sms: int = H100_SMS) -> int:
    """Waves of K2 blocks of ``block_frames`` frames on ``n_sms`` SMs,
    counting the blocks an SM is sure to hold: as many as its shared
    memory takes, and at most the launch bounds' minimum."""
    cap = K2_MIN_BLOCKS if gather_frame_threads(n_states) <= 32 else 1
    per_sm = max(1, min(cap, SMEM_PER_SM_BYTES // (smem_bytes + SMEM_BLOCK_RESERVE)))
    blocks = -(-n_frames // block_frames)
    return -(-blocks // (n_sms * per_sm))


def k2_block_frames(n_states: int, llr_block: int, n_cols: int, depth: int,
                    tile: int, packed: bool, n_frames: int,
                    n_sms: int = H100_SMS,
                    smem_limit: int = SMEM_LIMIT_BYTES):
    """(frames per K2 block, rings in shared memory?).

    Two layouts: the most frame groups (warps, up to ``GATHER_WARPS``;
    one frame where a frame spans warps) whose rings and maps fit in
    shared memory beside their staging, or ``GATHER_WARPS`` groups with
    the rings in a scratch buffer in device memory.  The one that takes
    fewer waves of ``n_frames`` frames (``k2_waves``) wins, shared memory
    on a tie: the step is latency-bound, so waves multiply the time, and
    a wave with the rings in device memory takes 1.7-2.3x as long as one
    with them in shared memory (``tools/k12_variants.py``).  At the
    streaming geometry (S = 64, D = 2560, TT = 32, packed, F = 512) four
    frames fit: 128 blocks, one wave on 132 SMs.  An int8 ring of that
    depth fits one frame a block, four waves at F = 512: its rings go to
    device memory, four frames a block, one wave."""
    S = n_states

    def smem(frames, in_smem):
        return k2_smem_bytes(S, llr_block, n_cols, depth, tile, packed, frames, in_smem)

    gf = gather_group_frames(S)
    max_groups = GATHER_WARPS if gather_frame_threads(S) <= 32 else 1
    hbm = max_groups * gf
    fit = next((g * gf for g in range(max_groups, 0, -1)
                if smem(g * gf, True) <= smem_limit), None)
    if fit is not None and (k2_waves(n_frames, S, fit, smem(fit, True), n_sms)
                            <= k2_waves(n_frames, S, hbm, smem(hbm, False), n_sms)):
        return fit, True
    return hbm, False


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


def gather_tables(w: torch.Tensor, llr_block: int, n_states: int,
                  n_slots: int):
    """(theta (B, S*R), pred (S, R) int64): W's LLR half, which K1
    (tropical), K2 and K3 take in place of W, and the predecessor of each
    (state, slot) as W's metric half routes it.

    The kernels form each potential as a branch metric plus the one
    predecessor metric, so they take only a W whose metric half is the 0/1
    one-hot of the shift register, ``pred(j, r) = ((j & mask) << rho) |
    r`` with ``mask = 2^(k-1-rho) - 1`` and S = 2^(k-1), as
    ``trellis.build_acs_tables`` makes it.  Raises ``ValueError`` on any
    other: a shape that is not (B + S, S * R), an R that is not a radix
    of S, a column that is not exactly one 1.0 among 0.0s, or a one in
    another row than the rule's.  Reads W on the host."""
    S, R, B = n_states, n_slots, llr_block
    if R not in SLOT_BITS or S < R or S & (S - 1):
        raise ValueError(
            f"the gathered kernels need S = 2^(k-1) states and R = 2^rho <= S "
            f"slots; got S={S}, R={R}"
        )
    if tuple(w.shape) != (B + S, S * R):
        raise ValueError(
            f"W has shape {tuple(w.shape)}, expected {(B + S, S * R)}"
        )
    rho = SLOT_BITS[R]
    mask = (1 << (S.bit_length() - 1 - rho)) - 1
    routing = w[B:].detach().to("cpu", torch.float32)
    rows = routing.argmax(dim=0)
    onehot = torch.zeros_like(routing)
    onehot[rows, torch.arange(S * R)] = 1.0
    if not torch.equal(routing, onehot):
        raise ValueError(
            "W's metric half is not one 1.0 per column among 0.0s, so a "
            "potential is not one predecessor metric plus a branch metric"
        )
    j = torch.arange(S)[:, None]
    want = ((j & mask) << rho) | torch.arange(R)[None, :]
    pred = rows.view(S, R)
    if not torch.equal(pred, want):
        raise ValueError(
            "W's metric half routes other predecessors than the shift "
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


# serving-engine cell geometry, the reference's: ragged request lengths
# are bucketed onto a power-of-two ladder starting here, so the number
# of distinct (F, T) cell shapes stays logarithmic in the length spread
# while per-request padding stays under 2x in the worst case
ENGINE_MIN_CELL = 64


def pick_cell_length(n: int, min_cell: int = ENGINE_MIN_CELL,
                     multiple: int = 1) -> int:
    """Length rung of a serving cell for an n-element request: the
    smallest power-of-two ladder rung >= n (and >= ``min_cell``), rounded
    up to ``multiple``, which punctured codes set to their kept bits a
    period so that every cell depunctures to whole periods."""
    if n <= 0:
        raise ValueError(f"request length must be positive, got {n}")
    cell = min_cell
    while cell < n:
        cell *= 2
    return cell + (-cell) % multiple


def pick_cell_frames(n: int, max_batch: int) -> int:
    """Frame rung of a serving cell: the smallest power of two >= ``n``,
    capped at ``max_batch``, so a cell is at least half real frames."""
    f = 1
    while f < min(n, max_batch):
        f *= 2
    return min(f, max_batch)
