"""Plain PyTorch versions of K1 (``viterbi_acs.acs_forward``), K2
(``viterbi_acs.acs_decode_fused``), K3 (``viterbi_acs.transfer_matrix``)
and K6 (``viterbi_acs.bcjr_sweep``): the same contracts, one radix step
at a time.  K1 and K3 take the semiring of their slot reduction by name:
``"tropical"`` (the max) or ``"logprob"`` (``Semiring.sum``'s
max-normalised logsumexp); K6 is LOGPROB only.

The wrappers run these for CPU tensors; the tests hold them against the
reference's Pallas kernels, and ``chip_smoke.py`` holds the CUDA kernels
against them on the card.  They repeat the kernels' arithmetic and are
no yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_geometry import (
    SLOT_BITS,
    check_packable,
    gather_tables,
    pack_slots,
    ring_dtype,
    ring_words,
)
from repro_torch.core.semiring import LOGPROB, NEG, get_semiring
from repro_torch.core.viterbi import AcsPrecision, dot_f32, fused_potentials

__all__ = [
    "acs_forward_ref", "acs_forward_gather_ref", "acs_decode_fused_ref",
    "acs_decode_fused_maps_ref", "transfer_matrix_ref", "bcjr_forward_ref",
    "bcjr_backward_ref", "bcjr_sweep_ref",
]


def acs_forward_ref(
    blocks: torch.Tensor,  # (T, F, B)
    lam0: torch.Tensor,  # (F, S)
    w: torch.Tensor,  # (B+S, S*R)
    *,
    n_states: int,
    n_slots: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    pack_survivors: bool = False,
    semiring: str = "tropical",
):
    """Returns (lam_final (F, S) f32, phi (T, F, S) int8 or packed
    (T, F, S//16) int32).  Per step: x = [L_t | Lambda] rounded to
    ``matmul_dtype``, pot = x @ W in f32, Lambda' = the semiring's slot
    reduction (max, or logsumexp), phi = first slot argmax at either
    semiring, optional per-frame max subtraction, carry rounded to
    ``carry_dtype``."""
    reduce = get_semiring(semiring).sum
    S, R = n_states, n_slots
    if pack_survivors:
        check_packable(S, R)
    T, F = blocks.shape[0], blocks.shape[1]
    w = w.to(matmul_dtype)
    blocks = blocks.to(matmul_dtype)
    phis = torch.empty(
        (T, F, ring_words(S, pack_survivors)),
        dtype=ring_dtype(pack_survivors), device=blocks.device,
    )
    lam = lam0.to(carry_dtype)
    for t in range(T):
        x = torch.cat([blocks[t], lam.to(matmul_dtype)], dim=1)
        pot = dot_f32(x, w).view(F, S, R)
        new = reduce(pot, dim=-1)
        phi = pot.argmax(dim=-1)
        phis[t] = pack_slots(phi, R) if pack_survivors else phi
        if renorm:
            new = new - new.amax(dim=-1, keepdim=True)
        lam = new.to(carry_dtype)
    return lam.to(torch.float32), phis


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of f32 tensors: the product is exact in f64, the sum
    rounds once to f64 and then to f32 (a double rounding, which can move
    a result that falls exactly between two f32 values by one unit)."""
    return (a.double() * b.double() + c.double()).float()


def _tournament_logsumexp(pot: torch.Tensor) -> torch.Tensor:
    """``reduce_slots<R, kLogprob>`` of csrc/acs_step.cuh over the last
    axis: the max by a tournament of pairs, then 1 and the R - 1 losers'
    exp summed in the tournament's order (its first level's pairs first),
    then the log; f32 throughout."""
    top, losers = pot, []
    while top.shape[-1] > 1:
        a, b = top[..., 0::2], top[..., 1::2]
        losers.append(torch.minimum(a, b))
        top = torch.maximum(a, b)
    top = top[..., 0]
    total = torch.ones_like(top)
    for lose in torch.cat(losers, dim=-1).unbind(-1):
        total = total + torch.exp(lose - top)
    return top + torch.log(total)


def acs_forward_gather_ref(
    blocks: torch.Tensor,  # (T, F, B)
    lam0: torch.Tensor,  # (F, S)
    w: torch.Tensor,  # (B+S, S*R), its metric half the shift register's one-hot
    *,
    n_states: int,
    n_slots: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    pack_survivors: bool = False,
    semiring: str = "tropical",
):
    """A model of K1's gathered step (csrc/acs_forward.cu), for the tests:
    ``acs_forward_ref``'s contract and outputs, in the kernel's own
    arithmetic order.  The tests hold it to the reference's K1 on the CPU
    and, on the card, hold the kernel to it at a bound that allows only
    the exponentials, the log and what they move to differ.

    Per step: the branch metric of each of Theta's distinct columns, an
    fmaf chain in k order from 0 over L and Theta rounded to
    ``matmul_dtype`` (``_fma_f32``); each potential one f32 add of its
    column's branch metric and the one predecessor metric that W's
    one-hot half routes (``kernel_geometry.gather_tables``, which raises
    on any other W); the first argmax; the slot value the max, or at
    ``"logprob"`` the tournament logsumexp of ``reduce_slots``
    (``torch.exp`` and ``torch.log`` where the kernel takes CUDA's
    accurate ``expf`` and ``log_of_sum``, each within 2 ulp); the renorm
    by the frame max of those values; the carry rounded to
    ``carry_dtype``, the next metrics to ``matmul_dtype``."""
    get_semiring(semiring)  # raises on a name it does not know
    S, R = n_states, n_slots
    if pack_survivors:
        check_packable(S, R)
    T, F, B = blocks.shape
    theta, pred = gather_tables(w, B, S, R)
    cols, cid = torch.unique(theta.T.to(torch.float32), dim=0, return_inverse=True)
    cols = cols.T.to(matmul_dtype).to(torch.float32)  # (B, n_u)
    pred = pred.to(blocks.device)
    lsum = blocks.to(matmul_dtype).to(torch.float32)
    phis = torch.empty(
        (T, F, ring_words(S, pack_survivors)),
        dtype=ring_dtype(pack_survivors), device=blocks.device,
    )
    lam = lam0.to(torch.float32).to(carry_dtype).to(torch.float32)
    for t in range(T):
        bm = torch.zeros((F, cols.shape[1]), dtype=torch.float32, device=blocks.device)
        for k in range(B):
            bm = _fma_f32(lsum[t, :, k, None], cols[k][None, :], bm)
        x = lam.to(matmul_dtype).to(torch.float32)
        pot = (bm[:, cid.to(blocks.device)] + x[:, pred.reshape(-1)]).view(F, S, R)
        phi = pot.argmax(dim=-1)  # the first of equal maxima
        new = _tournament_logsumexp(pot) if semiring == "logprob" else pot.amax(dim=-1)
        phis[t] = pack_slots(phi, R) if pack_survivors else phi
        if renorm:
            new = new - new.amax(dim=-1, keepdim=True)
        lam = new.to(carry_dtype).to(torch.float32)
    return lam, phis


def _ring_select(row: torch.Tensor, state: torch.Tensor, n_slots: int,
                 packed: bool) -> torch.Tensor:
    """Slot of each frame's ``state`` in one ring step ``row`` (F, W):
    a byte of the int8 ring, or a ``SLOT_BITS`` field of a packed word."""
    if packed:
        word = row.gather(1, (state >> 4)[:, None])[:, 0].to(torch.int64)
        return (word >> (SLOT_BITS[n_slots] * (state & 15))) & (n_slots - 1)
    return row.gather(1, state[:, None])[:, 0].to(torch.int64)


def acs_decode_fused_ref(
    blocks: torch.Tensor,  # (T, F, B), T a multiple of time_tile
    lam0: torch.Tensor,  # (F, S)
    hist0: torch.Tensor,  # (D, F, W) entry ring, chronological
    w: torch.Tensor,  # (B+S, S*R)
    *,
    n_states: int,
    n_slots: int,
    k: int,
    rho: int,
    time_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    pack_survivors: bool = False,
):
    """Returns (bits (T*rho, F) int8, lam (F, S) f32, hist (D, F, W)).

    Per time tile of TT steps: the ACS steps of ``acs_forward_ref`` write
    their survivors into a ring of D+TT steps (step s at slot s mod
    (D+TT); the entry ring's steps -D..-1 at slots TT..), then a walk
    from the argmax of the metrics over the newest D steps, then TT
    emitting steps over the oldest tile, each giving the rho decided
    bits LSB-first.  The exit ring is the newest D steps in time order.
    """
    T, F = blocks.shape[0], blocks.shape[1]
    D, TT = hist0.shape[0], time_tile
    RING = D + TT
    n_ring_tiles = RING // TT
    shift = k - 1 - rho
    mask = (1 << shift) - 1
    ring = torch.zeros(
        (RING, F, hist0.shape[2]), dtype=hist0.dtype, device=hist0.device
    )
    ring[TT:] = hist0
    bits = torch.empty((T * rho, F), dtype=torch.int8, device=blocks.device)
    bit_idx = torch.arange(rho, device=blocks.device)
    lam = lam0
    n_tiles = T // TT
    for j in range(n_tiles):
        lam, phi = acs_forward_ref(
            blocks[j * TT:(j + 1) * TT], lam, w, n_states=n_states,
            n_slots=n_slots, carry_dtype=carry_dtype,
            matmul_dtype=matmul_dtype, renorm=renorm,
            pack_survivors=pack_survivors,
        )
        write_base = (j % n_ring_tiles) * TT
        ring[write_base:write_base + TT] = phi
        read_base = ((j + 1) % n_ring_tiles) * TT  # slot of the window's oldest step
        state = lam.argmax(dim=-1)
        for i in range(RING - 1, -1, -1):
            if i < TT:  # the oldest tile: emit the rho bits of step i
                v = state >> shift
                rows = slice((j * TT + i) * rho, (j * TT + i + 1) * rho)
                bits[rows] = ((v[None, :] >> bit_idx[:, None]) & 1).to(torch.int8)
            slot = (read_base + i) % RING
            sel = _ring_select(ring[slot], state, n_slots, pack_survivors)
            state = ((state & mask) << rho) | sel
    base = ((n_tiles + 1) % n_ring_tiles) * TT
    order = (base + torch.arange(D, device=ring.device)) % RING
    return bits, lam, ring[order]


def _ring_select_many(row: torch.Tensor, states: torch.Tensor, n_slots: int,
                      packed: bool) -> torch.Tensor:
    """``_ring_select`` for (F, n) states of each frame."""
    if packed:
        word = row.gather(1, states >> 4).to(torch.int64)
        return (word >> (SLOT_BITS[n_slots] * (states & 15))) & (n_slots - 1)
    return row.gather(1, states).to(torch.int64)


def acs_decode_fused_maps_ref(
    blocks: torch.Tensor,  # (T, F, B), T a multiple of time_tile
    lam0: torch.Tensor,  # (F, S)
    hist0: torch.Tensor,  # (D, F, W) entry ring, chronological
    w: torch.Tensor,  # (B+S, S*R)
    *,
    n_states: int,
    n_slots: int,
    k: int,
    rho: int,
    time_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    pack_survivors: bool = False,
):
    """A model of K2's walk, for the tests: ``acs_decode_fused_ref``'s
    contract and outputs, with the sliding-window walk done as the CUDA
    kernel does it (``csrc/acs_decode_fused.cu``).

    Each ring tile of TT steps has a map: map[s] is the state at the
    tile's start of the survivor path that ends in state s at its last
    step.  A new tile's map follows each state's origin through the
    tile's survivors step by step, as the kernel carries it through its
    ACS steps; an entry-ring tile's map walks TT steps back from every
    state.  After each tile the walk composes the D/TT lookahead maps,
    newest first, from the first argmax of the metrics, then walks and
    emits the oldest tile's TT steps through the survivors (the kernel
    does this on a warp of its own while the next tile's ACS runs, with a
    ring one tile longer; the order of the walk's steps is this one).  The
    plain version walks D + TT dependent steps instead; both must give the
    same bits.
    """
    T, F = blocks.shape[0], blocks.shape[1]
    S, D, TT = n_states, hist0.shape[0], time_tile
    RING = D + TT
    n_ring = RING // TT
    shift = k - 1 - rho
    mask = (1 << shift) - 1
    pack = pack_survivors
    dev = blocks.device
    ring = torch.zeros((RING, F, hist0.shape[2]), dtype=hist0.dtype, device=dev)
    ring[TT:] = hist0
    every = torch.arange(S, device=dev).expand(F, S)

    def pred(states, row):
        return ((states & mask) << rho) | _ring_select_many(row, states, n_slots, pack)

    def walked_map(rt):  # an entry tile: TT steps back from every state
        st = every
        for i in range(TT - 1, -1, -1):
            st = pred(st, ring[rt * TT + i])
        return st

    def tracked_map(rt):  # a new tile: each state's origin, step by step
        origin = None
        for i in range(TT):
            p = pred(every, ring[rt * TT + i])
            origin = p if origin is None else origin.gather(1, p)
        return origin

    maps = [None] + [walked_map(rt) for rt in range(1, n_ring)]
    bits = torch.empty((T * rho, F), dtype=torch.int8, device=dev)
    bit_idx = torch.arange(rho, device=dev)
    lam = lam0
    n_tiles = T // TT
    for j in range(n_tiles):
        lam, phi = acs_forward_ref(
            blocks[j * TT:(j + 1) * TT], lam, w, n_states=S, n_slots=n_slots,
            carry_dtype=carry_dtype, matmul_dtype=matmul_dtype, renorm=renorm,
            pack_survivors=pack,
        )
        rt_new = j % n_ring
        ring[rt_new * TT:(rt_new + 1) * TT] = phi
        maps[rt_new] = tracked_map(rt_new)
        state = lam.argmax(dim=-1)
        for q in range(n_ring - 1):  # the lookahead, newest tile first
            state = maps[(rt_new - q) % n_ring].gather(1, state[:, None])[:, 0]
        oldest = ((j + 1) % n_ring) * TT
        for i in range(TT - 1, -1, -1):  # the oldest tile: emit, then walk
            v = state >> shift
            rows = slice((j * TT + i) * rho, (j * TT + i + 1) * rho)
            bits[rows] = ((v[None, :] >> bit_idx[:, None]) & 1).to(torch.int8)
            state = pred(state[:, None], ring[oldest + i])[:, 0]
    base = ((n_tiles + 1) % n_ring) * TT
    order = (base + torch.arange(D, device=dev)) % RING
    return bits, lam, ring[order]


def transfer_matrix_ref(
    blocks: torch.Tensor,  # (T, F, B), T a multiple of transfer_tile
    w: torch.Tensor,  # (B+S, S*R)
    *,
    n_states: int,
    n_slots: int,
    transfer_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    split_dot: bool = False,
    semiring: str = "tropical",
):
    """Returns M (N, F, S, S) f32, N = T / transfer_tile: per tile, the
    transfer matrices of ``semiring``, each (tile, frame) normalised by
    its max.

    Every tile starts from the identity (0 on the diagonal, -1e9 off it)
    and runs ``transfer_tile`` fused steps with the entry axis folded
    into N*F*S rows: pot = [L_t | M] @ W in f32 (with ``split_dot`` the
    M half in f32, unrounded), the slot reduction (max, or logsumexp),
    carry rounded to ``carry_dtype``.  No per-row renorm: an offset per entry state would
    change the products."""
    sr = get_semiring(semiring)
    T, F, B = blocks.shape
    S, R, TT = n_states, n_slots, transfer_tile
    if TT <= 0 or T % TT:
        raise ValueError(f"T'={T} steps not divisible by transfer_tile={TT}")
    N = T // TT
    rows = N * F * S
    precision = AcsPrecision(
        matmul_dtype=matmul_dtype, carry_dtype=carry_dtype, split_dot=split_dot
    )
    w_mm = w.to(matmul_dtype)
    w_pred = w[B:].to(torch.float32)
    tiles = blocks.reshape(N, TT, F, B)
    m = sr.identity(S, device=blocks.device).expand(N, F, S, S)
    for t in range(TT):
        l_t = tiles[:, t, :, None, :].expand(N, F, S, B).reshape(rows, B)
        pot = fused_potentials(
            l_t, m.reshape(rows, S), w_mm, w_mm[:B], w_pred, precision
        )
        new = sr.sum(pot.view(rows, S, R), dim=-1)
        m = new.to(carry_dtype).to(torch.float32).view(N, F, S, S)
    return m - m.amax(dim=(-2, -1), keepdim=True)


def _sweep_rows(blocks: torch.Tensor, tt: int, matmul_dtype) -> torch.Tensor:
    """(T', F, B) -> (tt, N*F, B): step t of row p*F + f is step p*tt + t
    of frame f, rounded to ``matmul_dtype``."""
    T, F, B = blocks.shape
    rows = blocks.reshape(T // tt, tt, F, B).permute(1, 0, 2, 3).reshape(tt, -1, B)
    return rows.to(matmul_dtype).to(torch.float32)


def _sweep_step_ref(l_t, lam, cols, operands, S, R, *, carry_dtype, matmul_dtype,
                    renorm, split_dot):
    """K6's step on rows (rows, B) and metrics (rows, S): each column's
    branch metric an fmaf chain in k order (``_fma_f32``), each potential
    that plus the routed metric (rounded to ``matmul_dtype`` unless
    ``split_dot``), the tournament logsumexp, the renorm, the carry."""
    bm = torch.zeros((l_t.shape[0], cols.shape[1]), dtype=torch.float32, device=l_t.device)
    for k in range(l_t.shape[1]):
        bm = _fma_f32(l_t[:, k, None], cols[k][None, :], bm)
    x = lam if split_dot else lam.to(matmul_dtype).to(torch.float32)
    cid = operands.cid.to(torch.int64)
    route = operands.route.to(torch.int64)
    pot = (bm[:, cid] + x[:, route]).view(-1, S, R)
    new = _tournament_logsumexp(pot)
    if renorm:
        new = new - new.amax(dim=-1, keepdim=True)
    return new.to(carry_dtype).to(torch.float32)


def bcjr_forward_ref(
    blocks: torch.Tensor,  # (T', F, B)
    entry: torch.Tensor,  # (N, F, S) tile-entry alphas
    operands,  # viterbi_acs.SweepOperands of the forward tables
    *,
    transfer_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    split_dot: bool = False,
) -> torch.Tensor:
    """K6-F's plain version: the alphas at boundaries 1..tt of every row
    p*F + f, (tt, N*F, S) f32, in the kernel's arithmetic order
    (``_sweep_step_ref``; ``torch.exp`` and ``torch.log`` where the kernel
    takes CUDA's accurate ``expf`` and ``log_of_sum``).  The same
    rounding points as ``soft._alpha_scan``."""
    N, F, S = entry.shape
    R = operands.cid.numel() // S
    tiles = _sweep_rows(blocks, transfer_tile, matmul_dtype)
    cols = operands.cols.to(matmul_dtype).to(torch.float32)
    lam = entry.reshape(N * F, S).to(carry_dtype).to(torch.float32)
    alphas = torch.empty((transfer_tile, N * F, S), dtype=torch.float32, device=entry.device)
    for t in range(transfer_tile):
        lam = _sweep_step_ref(tiles[t], lam, cols, operands, S, R, carry_dtype=carry_dtype,
                              matmul_dtype=matmul_dtype, renorm=renorm, split_dot=split_dot)
        alphas[t] = lam
    return alphas


def _joint_llrs(joint: torch.Tensor, dec: torch.Tensor, rho: int) -> torch.Tensor:
    """(rows, S) boundary joints -> (rows, rho) LLRs: per bit, the
    logsumexp of the joints whose state has the bit 0 less that of those
    with the bit 1, every other state standing in as NEG, as
    ``soft._llrs_from_joints`` masks them."""
    neg = torch.tensor(NEG, dtype=torch.float32, device=joint.device)
    out = []
    for b in range(rho):
        one = ((dec.to(torch.int64) >> b) & 1).bool()[None, :]
        out.append(LOGPROB.sum(torch.where(one, neg, joint), dim=-1)
                   - LOGPROB.sum(torch.where(one, joint, neg), dim=-1))
    return torch.stack(out, dim=-1)


def bcjr_backward_ref(
    blocks: torch.Tensor,  # (T', F, B)
    beta_tile_end: torch.Tensor,  # (N, F, S) tile-end betas
    alphas: torch.Tensor,  # (tt, N*F, S) the forward sweep's alphas
    operands,  # viterbi_acs.SweepOperands of the reversed tables
    *,
    transfer_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    split_dot: bool = False,
) -> torch.Tensor:
    """K6-B's plain version: the LLRs (F, T' * rho) f32.  Per row, from
    t = tt-1 down to 0: the LLRs of the joint alpha[t] + beta at boundary
    t+1 (``_joint_llrs``), the beta at boundary tt being the tile-end beta
    unrounded, then for t >= 1 the reverse step (``_sweep_step_ref``) to
    the beta at boundary t.  The same rounding points as
    ``soft._beta_scan`` and ``soft._llrs_from_joints``."""
    N, F, S = beta_tile_end.shape
    R = operands.cid.numel() // S
    rho = R.bit_length() - 1
    tt = transfer_tile
    tiles = _sweep_rows(blocks, tt, matmul_dtype)
    cols = operands.cols.to(matmul_dtype).to(torch.float32)
    beta = beta_tile_end.reshape(N * F, S).to(torch.float32)
    lam = beta.to(carry_dtype).to(torch.float32)
    llr = torch.empty((tt, N * F, rho), dtype=torch.float32, device=beta.device)
    for t in range(tt - 1, -1, -1):
        llr[t] = _joint_llrs(alphas[t] + beta, operands.dec, rho)
        if t:
            lam = _sweep_step_ref(tiles[t], lam, cols, operands, S, R,
                                  carry_dtype=carry_dtype, matmul_dtype=matmul_dtype,
                                  renorm=renorm, split_dot=split_dot)
            beta = lam
    return llr.view(tt, N, F, rho).permute(2, 1, 0, 3).reshape(F, N * tt * rho)


def bcjr_sweep_ref(blocks, entry, beta_tile_end, forward, backward, *,
                   transfer_tile: int, **precision) -> torch.Tensor:
    """K6's plain version whole: (blocks (T', F, B), tile-entry alphas and
    tile-end betas (N, F, S)) -> LLRs (F, T' * rho), ``bcjr_forward_ref``
    on the forward tables' operands, then ``bcjr_backward_ref`` on the
    reversed tables'."""
    alphas = bcjr_forward_ref(blocks, entry, forward, transfer_tile=transfer_tile,
                              **precision)
    return bcjr_backward_ref(blocks, beta_tile_end, alphas, backward,
                             transfer_tile=transfer_tile, **precision)
