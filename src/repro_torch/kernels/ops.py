"""Public kernel wrappers bound to ``core.viterbi`` and ``core.decoder``.

``viterbi_forward`` is plug-compatible with ``core.viterbi.forward_fused``
and is selected there by ``use_kernel=True``: the two-pass path, with the
full survivor tensor written out and a plain PyTorch traceback after it.
``viterbi_decode_fused`` is the one-pass time-tiled path (K2): ACS and a
sliding-window traceback in one kernel, the survivors kept in its ring.
``viterbi_transfer_matrices`` is the formation of the time-parallel
decode (K3), plug-compatible with ``core.timeparallel.transfer_matrices``
and selected there by ``use_kernel=True``.  ``bcjr_sweep`` is the BCJR's
within-tile sweeps (K6-F, and K6-B with the LLR combine), which
``core.soft.bcjr_llrs`` takes on the card with ``use_kernel=True``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.core import kernel_geometry
from repro_torch.core.kernel_geometry import DEFAULT_TIME_TILE
from repro_torch.core.trellis import AcsTables, ReverseTables
from repro_torch.core.viterbi import AcsPrecision
from repro_torch.obs.trace import stage

from .viterbi_acs import (
    GatherOperands, SweepOperands, acs_decode_fused, acs_forward, gather_operands,
    sweep_operands, transfer_matrix,
)
from .viterbi_acs import bcjr_sweep as _bcjr_sweep

__all__ = [
    "viterbi_forward", "viterbi_decode_fused", "viterbi_transfer_matrices",
    "bcjr_sweep", "ring_words", "ring_dtype", "device_tables", "device_sweep_tables",
]


def ring_words(tables: AcsTables, pack_survivors: bool) -> int:
    """Last-axis width of a survivor ring entry for these tables."""
    return kernel_geometry.ring_words(tables.n_states, pack_survivors)


ring_dtype = kernel_geometry.ring_dtype


@functools.lru_cache(maxsize=64)
def device_tables(tables: AcsTables,
                  device: torch.device) -> Tuple[torch.Tensor, GatherOperands]:
    """The tables' fused W on ``device`` and the gathered kernels'
    operands, made once per (tables, device): W's metric half is checked
    here (``gather_operands``) on the tables' host copy, so no launch of
    a stream reads W back from the card."""
    host = torch.as_tensor(tables.fused_w)
    cols, cid = gather_operands(host, tables.llr_block, tables.n_states, tables.n_slots)
    return (host.to(device),
            GatherOperands(cols.to(device), cid.to(device)))


def viterbi_forward(
    blocks: torch.Tensor,  # (T, F, B)
    lam0: torch.Tensor,  # (F, S)
    tables: AcsTables,
    precision=None,
    *,
    pack_survivors: bool = False,
    semiring: str = "tropical",
):
    """K1-backed fused forward; ``semiring`` ("tropical" or "logprob")
    selects the slot reduction.

    Returns (lam (F,S) f32, phi) with phi (T, F, S) int8 slot indices, or
    (T, F, S//16) int32 PACKED words when ``pack_survivors`` —
    ``core.viterbi.traceback`` reads the packed words as they are.
    """
    precision = precision or AcsPrecision()
    w, operands = device_tables(tables, blocks.device)
    with stage("k1", device=blocks.device, semiring=semiring):
        return acs_forward(
            blocks.to(torch.float32).contiguous(),
            lam0.to(torch.float32).contiguous(),
            w,
            n_states=tables.n_states,
            n_slots=tables.n_slots,
            carry_dtype=precision.carry_dtype,
            matmul_dtype=precision.matmul_dtype,
            renorm=precision.renorm,
            pack_survivors=pack_survivors,
            semiring=semiring,
            operands=operands,
        )


def viterbi_decode_fused(
    blocks: torch.Tensor,  # (T, F, B), T divisible by the time tile
    lam0: torch.Tensor,  # (F, S)
    hist0: torch.Tensor,  # (D, F, W) survivor ring (zeros for a fresh stream)
    tables: AcsTables,
    precision=None,
    *,
    time_tile: int = DEFAULT_TIME_TILE,
    pack_survivors: bool = False,
):
    """K2-backed one-pass time-tiled streaming decode.

    Returns (bits (T*rho, F) int8, lam (F, S) f32, hist (D, F, W)):
    delayed decisions for steps [-D, T-D) plus the carried stream state,
    the fused equivalent of T/time_tile two-pass chunk steps.
    """
    precision = precision or AcsPrecision()
    w, operands = device_tables(tables, blocks.device)
    with stage("k2", device=blocks.device):
        return acs_decode_fused(
            blocks.to(torch.float32).contiguous(),
            lam0.to(torch.float32).contiguous(),
            hist0.contiguous(),
            w,
            n_states=tables.n_states,
            n_slots=tables.n_slots,
            k=tables.spec.k,
            rho=tables.rho,
            time_tile=time_tile,
            carry_dtype=precision.carry_dtype,
            matmul_dtype=precision.matmul_dtype,
            renorm=precision.renorm,
            pack_survivors=pack_survivors,
            operands=operands,
        )


def viterbi_transfer_matrices(
    blocks: torch.Tensor,  # (T, F, B), T divisible by transfer_tile
    tables: AcsTables,
    precision=None,
    *,
    transfer_tile: int,
    semiring: str = "tropical",
):
    """K3-backed transfer-matrix formation: per-tile transfer matrices
    M (N, F, S, S) f32 of ``semiring``, each (tile, frame) normalised by
    its max.  The blocks are rounded to ``precision.channel_dtype`` first, as
    in the reference; ``split_dot`` is honoured."""
    precision = precision or AcsPrecision()
    w, operands = device_tables(tables, blocks.device)
    with stage("k3", device=blocks.device, semiring=semiring):
        return transfer_matrix(
            blocks.to(precision.channel_dtype).to(torch.float32).contiguous(),
            w,
            n_states=tables.n_states,
            n_slots=tables.n_slots,
            transfer_tile=transfer_tile,
            carry_dtype=precision.carry_dtype,
            matmul_dtype=precision.matmul_dtype,
            split_dot=precision.split_dot,
            semiring=semiring,
            operands=operands,
        )


@functools.lru_cache(maxsize=64)
def device_sweep_tables(tables: AcsTables, rev: ReverseTables,
                        device: torch.device) -> Tuple[SweepOperands, SweepOperands]:
    """K6's operands of both directions on ``device``, made once per
    (tables, device): the forward sweep's from ``theta_t`` and
    ``pred_onehot``, the backward sweep's from ``theta_rev`` and
    ``succ_onehot``, both with ``dec_bits``.  The routing halves are
    checked here on the host (``sweep_operands`` raises on one that is
    not a one-hot), so no launch uploads or reads a table."""
    fwd = sweep_operands(tables.theta_t, tables.pred_onehot, tables.dec_bits)
    bwd = sweep_operands(rev.theta_rev, rev.succ_onehot, tables.dec_bits)
    return tuple(SweepOperands(*(x.to(device) for x in ops)) for ops in (fwd, bwd))


def bcjr_sweep(
    blocks: torch.Tensor,  # (T', F, B) half-scaled channel scores
    metric: torch.Tensor,  # (N, F, S) tile-entry alphas, or tile-end betas
    tables: AcsTables,
    rev: ReverseTables,
    precision=None,
    *,
    transfer_tile: int,
    alphas=None,
):
    """K6-backed within-tile sweep: without ``alphas`` the alphas (tt,
    N*F, S) from the tile-entry alphas (K6-F); with them the LLRs (F,
    T' * rho) from the tile-end betas (K6-B).  The blocks are rounded to
    ``precision.channel_dtype`` first, as ``core.soft`` rounds its
    tiles."""
    precision = precision or AcsPrecision()
    fwd, bwd = device_sweep_tables(tables, rev, blocks.device)
    if precision.channel_dtype != torch.float32:
        blocks = blocks.to(precision.channel_dtype).to(torch.float32)
    return _bcjr_sweep(
        blocks, metric, fwd if alphas is None else bwd,
        transfer_tile=transfer_tile, alphas=alphas,
        carry_dtype=precision.carry_dtype, matmul_dtype=precision.matmul_dtype,
        renorm=precision.renorm, split_dot=precision.split_dot,
    )
