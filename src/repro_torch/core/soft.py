"""Soft-output decoding: BCJR per-bit LLRs and top-L list-Viterbi (the
reference's ``core/soft.py``), both built on the semiring-generalised
fused ACS step.

**BCJR is the fused recurrence at LOGPROB.**  With the channel LLRs
scaled to true branch log-likelihoods (theta . lambda / 2), the forward
alpha recursion is the fused step with a logsumexp slot reduction, and
the backward beta recursion is the same matmul shape on the
time-reversed tables (``trellis.build_reverse_tables``).  The rho input
bits of step t are a function of the arrival state j at boundary t+1
alone (``tables.dec_bits``), so per-bit posteriors need only the
boundary joints  joint_{t+1}[j] = alpha_{t+1}[j] + beta_{t+1}[j]  and

    LLR[t, b] = lse_{j: bit_b(j)=0} joint  -  lse_{j: bit_b(j)=1} joint.

Open frames (``bcjr_llrs``) take the time-parallel machinery of
``core/timeparallel.py`` at LOGPROB: tile transfer matrices (K3-LOGPROB
on the card), a forward associative scan for the tile-entry alphas, a
reverse scan (flipped compose) for the tile-end betas (K4-LOGPROB
composes both), then within-tile alpha and beta sweeps over all tiles at
once fill in every boundary.  On the card with ``use_kernel`` the sweeps
are K6: K6-F writes every boundary's alpha, K6-B walks the betas back
and forms each boundary's LLRs in registers, so no beta or joint is
stored; elsewhere the plain scans (``_alpha_scan``, ``_beta_scan``) and
``_llrs_from_joints`` run, one Python step per radix step.  Tail-biting
frames (``bcjr_circular_llrs``) get the exact circular BCJR: per-stage
matrices (K3-LOGPROB at one step a tile), prefix and suffix scans and
the diagonal contraction joint_{t+1}[j] = lse_s(P_t[s, j] + S_{t+1}[j,
s]), and the plain combine.  Every per-step renorm, per-tile
normalisation and combine max is a constant per (frame, boundary) and
cancels in the LLR difference.

**List-Viterbi** (``list_decode``) grows the metric carry a rank axis
(F, S, L), folded into the matmul rows, so candidates come from the same
``fused_potentials`` as the hard decode.  The L best of each state's
L*R candidates are taken by a stable descending sort (``_top_k``): among
equal candidates the lower index comes first, as ``jax.lax.top_k``
promises and ``torch.topk`` does not, which makes L=1 bit-exact with
``decode_batch``.  Survivors store the candidate index (prev_rank * R +
slot); the traceback walks (state, rank) chains.  ``wava_list_decode``
runs the WAVA loop over the list forward for tail-biting frames.

The list-forward and traceback scans, and the alpha and beta scans off
the kernel route, are plain PyTorch, one Python step per radix step, as
the traceback of ``core/viterbi.py`` is.
Functions that take LLRs take ``device`` (None is the card); the others
work on the device of their input tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.obs.trace import host_upload, stage

from .backend import resolve_device
from .kernel_geometry import pick_transfer_tile
from .semiring import LOGPROB, NEG
from .timeparallel import (
    _compose,
    associative_scan,
    entry_from_prefix,
    tiled_blocks,
    transfer_matrices,
)
from .trellis import (
    AcsTables,
    CodeSpec,
    ReverseTables,
    build_acs_tables,
    build_reverse_tables,
)
from .viterbi import AcsPrecision, blocks_from_llrs, fused_potentials, init_metric

__all__ = [
    "bcjr_llrs",
    "bcjr_circular_llrs",
    "list_decode",
    "list_forward",
    "list_traceback",
    "init_list_metric",
    "wava_list_decode",
]


# ---------------------------------------------------------------------------
# BCJR forward-backward (open trellis)
# ---------------------------------------------------------------------------


def _end_metric(
    n_frames: int, n_states: int, final_state: Optional[int], device
) -> torch.Tensor:
    """beta at the stream end: one-hot (pinned terminal) or uniform."""
    return init_metric(n_frames, n_states, final_state, device=device)


def _step_operands(theta, route, fused, precision, dev):
    """(W, W_theta, W_route) of a fused step on ``dev``: the stacked
    operand and its branch half in the matmul dtype, the routing half
    in f32."""
    mm = precision.matmul_dtype
    return (
        host_upload(fused, dev).to(mm),
        host_upload(theta, dev).to(mm),
        host_upload(route, dev),
    )


def _alpha_scan(blocks, lam0, tables: AcsTables, precision: AcsPrecision):
    """LOGPROB forward collecting alphas at every boundary: (T, rows, S).
    The step of ``forward_fused`` (same potentials, renorm and carry
    cast) emitting the metric instead of survivors."""
    dev = blocks.device
    S, R = tables.n_states, tables.n_slots
    T, rows = blocks.shape[0], lam0.shape[0]
    with stage("alpha", device=dev, steps=T):
        W, W_theta, W_pred = _step_operands(
            tables.theta_t, tables.pred_onehot, tables.fused_w, precision, dev
        )
        alphas = torch.empty((T, rows, S), dtype=torch.float32, device=dev)
        lam = lam0.to(precision.carry_dtype)
        for t in range(T):
            lam = _logprob_step(blocks[t], lam, W, W_theta, W_pred, S, R, precision)
            alphas[t] = lam
        return alphas


def _beta_scan(blocks, beta_end, rev: ReverseTables, precision: AcsPrecision):
    """LOGPROB backward collecting betas at boundaries 1..T:
    out[t] = beta at boundary t+1, (T, rows, S); out[T-1] = beta_end.
    The backward step is the forward fused-matmul shape on the reversed
    tables: beta_t[i] = lse_v( branch(i, v) + beta_{t+1}[succ(i, v)] )."""
    dev = blocks.device
    S, R = rev.n_states, rev.n_slots
    T, rows = blocks.shape[0], beta_end.shape[0]
    with stage("beta", device=dev, steps=T - 1):
        W, W_theta, W_succ = _step_operands(
            rev.theta_rev, rev.succ_onehot, rev.fused_w, precision, dev
        )
        betas = torch.empty((T, rows, S), dtype=torch.float32, device=dev)
        betas[T - 1] = beta_end.to(torch.float32)
        beta = beta_end.to(precision.carry_dtype)
        # processing block t gives the beta at boundary t, kept at out[t-1]
        for t in range(T - 1, 0, -1):
            beta = _logprob_step(blocks[t], beta, W, W_theta, W_succ, S, R, precision)
            betas[t - 1] = beta
        return betas


def _logprob_step(l_t, lam, W, W_theta, W_route, S, R, precision):
    """One fused step at LOGPROB, with the per-row renorm and the carry
    cast of the hard path."""
    pot = fused_potentials(l_t, lam, W, W_theta, W_route, precision)
    new = LOGPROB.sum(pot.view(lam.shape[0], S, R), dim=-1)
    if precision.renorm:
        new = new - new.amax(dim=-1, keepdim=True)
    return new.to(precision.carry_dtype)


def _llrs_from_joints(joint: torch.Tensor, tables: AcsTables) -> torch.Tensor:
    """joint (T, F, S) boundary log-posteriors -> LLRs (F, T*rho).

    The rho bits of step t are dec_bits(arrival state at boundary t+1),
    chronological: mask the joint by bit value and logsumexp over j.
    """
    with stage("llr_combine", device=joint.device):
        dec = host_upload(tables.dec_bits, joint.device)  # (S, rho)
        jt = joint[:, :, None, :]  # (T, F, 1, S)
        mask = dec.T[None, None]  # (1, 1, rho, S)
        neg = host_upload(torch.tensor(NEG, dtype=torch.float32), joint.device)
        pos = LOGPROB.sum(torch.where(mask == 0, jt, neg), dim=-1)
        llr = pos - LOGPROB.sum(torch.where(mask == 1, jt, neg), dim=-1)
        return llr.permute(1, 0, 2).reshape(joint.shape[1], -1)  # (F, T*rho)


def _tile_boundaries(
    blocks: torch.Tensor,  # (T', F, B) half-scaled channel scores
    lam0: torch.Tensor,  # (F, S) alpha at boundary 0
    beta_end: torch.Tensor,  # (F, S) beta at boundary T'
    tables: AcsTables,
    precision: AcsPrecision,
    transfer_tile: int,
    use_kernel: bool,
):
    """(entry, beta_tile_end), each (N, F, S): the alpha entering and the
    beta leaving every tile.  LOGPROB tile transfer matrices and forward
    and reverse associative scans give them in log depth."""
    m = transfer_matrices(
        blocks, tables, precision, transfer_tile, use_kernel=use_kernel,
        semiring=LOGPROB,
    )  # (N, F, S, S)
    mm = precision.matmul_dtype
    prefix = associative_scan(_compose(mm, LOGPROB, use_kernel=use_kernel), m)
    entry = entry_from_prefix(prefix, lam0, LOGPROB)  # (N, F, S) tile alphas
    del prefix
    suffix = associative_scan(
        _compose(mm, LOGPROB, flip=True, use_kernel=use_kernel), m, reverse=True)
    # beta at the start of tile p: suffix_p composed into the end metric
    beta_start = LOGPROB.sum(suffix + beta_end[None, :, None, :], dim=-1)
    del suffix, m
    return entry, torch.cat([beta_start[1:], beta_end[None]], dim=0)


def _bcjr_joints(
    blocks: torch.Tensor,  # (T', F, B) half-scaled channel scores
    lam0: torch.Tensor,  # (F, S) alpha at boundary 0
    beta_end: torch.Tensor,  # (F, S) beta at boundary T'
    tables: AcsTables,
    rev: ReverseTables,
    precision: AcsPrecision,
    transfer_tile: int,
    use_kernel: bool,
) -> torch.Tensor:
    """Boundary joints alpha+beta at boundaries 1..T': (T', F, S).

    The tile boundaries (``_tile_boundaries``), then the plain within-tile
    scans (tiles folded into the frame axis) fill in the per-step
    boundaries at tile depth.
    """
    T, F, B = blocks.shape
    S = tables.n_states
    tt = transfer_tile
    n_tiles = T // tt
    entry, beta_tile_end = _tile_boundaries(
        blocks, lam0, beta_end, tables, precision, tt, use_kernel)
    tiles = tiled_blocks(blocks.to(precision.channel_dtype), tt).reshape(
        tt, n_tiles * F, B
    )
    joint = _alpha_scan(tiles, entry.reshape(n_tiles * F, S), tables, precision)
    # alpha + beta, summed into the alphas' storage to spare one array
    joint += _beta_scan(
        tiles, beta_tile_end.reshape(n_tiles * F, S), rev, precision
    )
    joint = joint.view(tt, n_tiles, F, S)
    return joint.permute(1, 0, 2, 3).reshape(T, F, S)


def _sweeps_in_kernel(device: torch.device, use_kernel: bool) -> bool:
    """Whether ``bcjr_llrs`` takes the within-tile sweeps in K6: on the
    card with ``use_kernel``; the CPU keeps the plain scans."""
    return use_kernel and device.type == "cuda"


def _bcjr_sweep_llrs(blocks, lam0, beta_end, tables, rev, precision, tt, dev):
    """The tile boundaries, then K6-F inside the ``alpha`` stage and K6-B
    (the beta sweep and the LLR combine) inside the ``beta`` stage:
    LLRs (F, T' * rho)."""
    from repro_torch.kernels import ops as kernel_ops

    entry, beta_tile_end = _tile_boundaries(
        blocks, lam0, beta_end, tables, precision, tt, True)
    with stage("alpha", device=dev):
        alphas = kernel_ops.bcjr_sweep(
            blocks, entry, tables, rev, precision, transfer_tile=tt)
    del entry
    with stage("beta", device=dev):
        return kernel_ops.bcjr_sweep(
            blocks, beta_tile_end, tables, rev, precision, transfer_tile=tt,
            alphas=alphas)


def bcjr_llrs(
    llrs,  # (F, n, beta) channel LLRs
    spec: CodeSpec,
    rho: int = 2,
    initial_state: Optional[int] = 0,
    final_state: Optional[int] = None,
    precision: AcsPrecision = AcsPrecision(),
    transfer_tile: Optional[int] = None,
    use_kernel: bool = True,
    device=None,
) -> torch.Tensor:
    """Per-bit BCJR LLRs (F, n) f32 for open (non-circular) frames, on
    ``device`` (None is the card).

    Positive = bit 0 more likely (the hard decision is ``llr < 0``, the
    convention of the channel LLRs).  ``use_kernel`` (default) forms the
    tile transfer matrices in K3-LOGPROB and composes them in K4-LOGPROB
    (their plain versions on the CPU), and on the card runs the
    within-tile sweeps and the LLR combine in K6; ``use_kernel=False``
    runs the plain versions directly.
    """
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    tables = build_acs_tables(spec, rho)
    rev = build_reverse_tables(spec, rho)
    # theta . lambda is twice the branch log-likelihood (up to a per-bit
    # constant): scale once so alpha and beta are true log-domain scores
    blocks = blocks_from_llrs(llrs, rho) * 0.5
    F = llrs.shape[0]
    tt = pick_transfer_tile(blocks.shape[0], transfer_tile)
    lam0 = init_metric(F, spec.n_states, initial_state, device=dev)
    beta_end = _end_metric(F, spec.n_states, final_state, dev)
    if _sweeps_in_kernel(dev, use_kernel):
        return _bcjr_sweep_llrs(blocks, lam0, beta_end, tables, rev, precision, tt, dev)
    joint = _bcjr_joints(
        blocks, lam0, beta_end, tables, rev, precision, tt, use_kernel
    )
    return _llrs_from_joints(joint, tables)


# ---------------------------------------------------------------------------
# Exact circular BCJR (tail-biting)
# ---------------------------------------------------------------------------


def _bcjr_circular_joints(
    blocks: torch.Tensor,  # (T', F, B) half-scaled channel scores
    tables: AcsTables,
    precision: AcsPrecision,
    use_kernel: bool,
) -> torch.Tensor:
    """Boundary joints (T', F, S) of the exact tail-biting posterior.

    Per-stage LOGPROB matrices A_t, inclusive prefixes P_t = A_0 o..o A_t
    and shifted suffixes S_{t+1} = A_{t+1} o..o A_{T'-1}; every circular
    input sequence enters boundary state s and returns to s, so

        joint_{t+1}[j] = lse_s ( P_t[s, j] + S_{t+1}[j, s] ).

    Memory is T'*F*S^2 per scan: fine for tail-biting frame lengths.
    """
    T, F, _ = blocks.shape
    S = tables.n_states
    a = transfer_matrices(
        blocks, tables, precision, transfer_tile=1, use_kernel=use_kernel,
        semiring=LOGPROB,
    )  # (T', F, S, S) per-stage matrices
    mm = precision.matmul_dtype
    prefix = associative_scan(_compose(mm, LOGPROB, use_kernel=use_kernel), a)
    suffix = associative_scan(
        _compose(mm, LOGPROB, flip=True, use_kernel=use_kernel), a, reverse=True)
    del a
    ident = LOGPROB.identity(S, device=blocks.device).expand(1, F, S, S)
    suffix_next = torch.cat([suffix[1:], ident], dim=0)
    del suffix
    # joint[t][f, j] = lse_s prefix[t][f, s, j] + suffix_next[t][f, j, s]
    return LOGPROB.sum(prefix.transpose(-1, -2) + suffix_next, dim=-1)


def bcjr_circular_llrs(
    llrs,  # (F, n, beta) channel LLRs
    tables: AcsTables,
    precision: AcsPrecision = AcsPrecision(),
    use_kernel: bool = True,
    device=None,
) -> torch.Tensor:
    """Per-bit LLRs (F, n) f32 of the exact tail-biting posterior, on
    ``device`` (None is the card).  ``use_kernel`` forms the per-stage
    matrices in K3-LOGPROB at one step a tile and composes them in
    K4-LOGPROB."""
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    if llrs.shape[1] % tables.rho:
        raise ValueError(
            f"tail-biting frame length n={llrs.shape[1]} not divisible "
            f"by rho={tables.rho}; use rho=1 tables for odd lengths"
        )
    blocks = blocks_from_llrs(llrs, tables.rho) * 0.5
    joint = _bcjr_circular_joints(blocks, tables, precision, use_kernel)
    return _llrs_from_joints(joint, tables)


# ---------------------------------------------------------------------------
# Top-L list-Viterbi (rank-augmented parallel LVA)
# ---------------------------------------------------------------------------


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: the k largest values in
    descending order and their indices, the lower index first among
    equal values.  A stable descending sort keeps that order;
    ``torch.topk`` does not promise it."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def init_list_metric(lam0: torch.Tensor, n_list: int) -> torch.Tensor:
    """(F, S) -> (F, S, L) on lam0's device: rank 0 carries lam0, ranks
    > 0 are empty (NEG)."""
    lam = torch.full(
        tuple(lam0.shape) + (n_list,), NEG, dtype=torch.float32,
        device=lam0.device,
    )
    lam[:, :, 0] = lam0
    return lam


def list_forward(
    blocks: torch.Tensor,  # (T', F, B)
    lam0: torch.Tensor,  # (F, S, L)
    tables: AcsTables,
    precision: AcsPrecision = AcsPrecision(),
    n_list: int = 4,
):
    """Rank-augmented fused forward on the tensors' device.  Returns
    (lam (F, S, L) f32, phis (T', F, S, L) int32 candidate codes =
    prev_rank * R + slot).

    The rank axis folds into the matmul rows, so the potentials come
    from the same ``fused_potentials`` as the hard forward; at L=1 the
    candidates are its potentials and ``_top_k``'s tie order is its
    first argmax.  Renorm subtracts the per-frame max over (S, L).
    """
    dev = blocks.device
    S, R, L = tables.n_states, tables.n_slots, n_list
    F, B = lam0.shape[0], tables.llr_block
    T = blocks.shape[0]
    with stage("list_forward", device=dev, steps=T):
        W, W_theta, W_pred = _step_operands(
            tables.theta_t, tables.pred_onehot, tables.fused_w, precision, dev
        )
        blocks = blocks.to(precision.channel_dtype)
        phis = torch.empty((T, F, S, L), dtype=torch.int32, device=dev)
        lam = lam0.to(precision.carry_dtype)
        for t in range(T):
            lam_rows = lam.permute(2, 0, 1).reshape(L * F, S)
            l_rows = blocks[t][None].expand(L, F, B).reshape(L * F, B)
            pot = fused_potentials(l_rows, lam_rows, W, W_theta, W_pred, precision)
            cand = pot.view(L, F, S, R).permute(1, 2, 0, 3).reshape(F, S, L * R)
            new_lam, code = _top_k(cand, L)  # (F, S, L)
            if precision.renorm:
                new_lam = new_lam - new_lam.reshape(F, S * L).amax(dim=-1)[:, None, None]
            lam = new_lam.to(precision.carry_dtype)
            phis[t] = code
    return lam.to(torch.float32), phis


def list_traceback(
    phis: torch.Tensor,  # (T', F, S, L) int32 candidate codes
    lam: torch.Tensor,  # (F, S, L) f32 final metrics
    tables: AcsTables,
    n_list: int,
    final_state: Optional[int] = None,
):
    """Trace the L best (state, rank) chains.  Returns (bits (F, L,
    T'*rho) int32 metric-sorted, metrics (F, L) f32, start (F, L) int32
    path start states, the tail-biting consistency probe)."""
    T, F, S, L = phis.shape
    k, rho, R = tables.spec.k, tables.rho, tables.n_slots
    shift = k - 1 - rho
    mask = (1 << shift) - 1
    dev = phis.device
    if final_state is None:
        metrics, flat = _top_k(lam.reshape(F, S * L), n_list)
        j, rank = flat // L, flat % L
    else:
        metrics, rank = _top_k(lam[:, final_state, :], n_list)
        j = torch.full((F, n_list), final_state, dtype=torch.int64, device=dev)
    vs = torch.empty((T, F, n_list), dtype=torch.int64, device=dev)
    with stage("list_traceback", device=dev, steps=T):
        for t in range(T - 1, -1, -1):
            code = phis[t].reshape(F, S * L).gather(1, j * L + rank).to(torch.int64)
            vs[t] = j >> shift  # the rho decoded bits of this step
            j, rank = ((j & mask) << rho) | (code % R), code // R
    bits = (vs[..., None] >> torch.arange(rho, device=dev)) & 1  # (T, F, L, rho)
    bits = bits.permute(1, 2, 0, 3).reshape(F, n_list, T * rho)
    return bits.to(torch.int32), metrics, j.to(torch.int32)


def list_decode(
    llrs,  # (F, n, beta)
    spec: CodeSpec,
    n_list: int = 4,
    rho: int = 2,
    initial_state: Optional[int] = 0,
    final_state: Optional[int] = None,
    precision: AcsPrecision = AcsPrecision(),
    device=None,
):
    """Top-L list decode of open frames on ``device`` (None is the
    card).  Returns (bits (F, L, n) int32, metrics (F, L) f32): paths
    metric-sorted and distinct; L=1 bit-exact with ``decode_frames``."""
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    tables = build_acs_tables(spec, rho)
    blocks = blocks_from_llrs(llrs, rho)
    lam0 = init_list_metric(
        init_metric(llrs.shape[0], spec.n_states, initial_state, device=dev),
        n_list,
    )
    lam, phis = list_forward(blocks, lam0, tables, precision, n_list)
    bits, metrics, _ = list_traceback(phis, lam, tables, n_list, final_state)
    return bits, metrics


def wava_list_decode(
    llrs,  # (F, n, beta)
    tables: AcsTables,
    n_list: int = 4,
    precision: Optional[AcsPrecision] = None,
    max_iters: int = 4,
    device=None,
):
    """Tail-biting top-L list decode on ``device`` (None is the card):
    the WAVA loop over the list forward.  Returns (bits (F, L, n),
    metrics (F, L), converged (F,)).  The circulation and freeze
    bookkeeping of the reference's ``wava_decode``: at L=1 the rank-0
    path is its path."""
    precision = precision or AcsPrecision()
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    F, n, beta = llrs.shape
    if beta != tables.spec.beta:
        raise ValueError(f"llrs beta={beta} != code beta={tables.spec.beta}")
    if n % tables.rho:
        raise ValueError(
            f"tail-biting frame length n={n} not divisible by "
            f"rho={tables.rho}; use rho=1 tables for odd lengths"
        )
    blocks = blocks_from_llrs(llrs, tables.rho)
    lam = init_list_metric(
        init_metric(F, tables.n_states, None, device=dev), n_list
    )  # uniform boundary prior at rank 0
    done = torch.zeros(F, dtype=torch.bool, device=dev)
    out = torch.zeros((F, n_list, n), dtype=torch.int32, device=dev)
    out_metrics = torch.zeros((F, n_list), dtype=torch.float32, device=dev)
    for _ in range(max_iters):
        lam, phis = list_forward(blocks, lam, tables, precision, n_list)
        bits, metrics, start = list_traceback(phis, lam, tables, n_list, None)
        # consistency on the best path, like wava_decode's argmax probe
        fs = lam.amax(dim=-1).argmax(dim=-1).to(torch.int32)
        consistent = start[:, 0] == fs
        out = torch.where(done[:, None, None], out, bits)
        out_metrics = torch.where(done[:, None], out_metrics, metrics)
        done = done | consistent
    return out, out_metrics, done
