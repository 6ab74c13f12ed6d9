"""Time-parallel decode through tropical transfer matrices (the
reference's ``core/timeparallel.py``).

The ACS recurrence  Lambda_{t+1}[j] = max_i (Lambda_t[i] + A_t[i, j])  is
a max-plus matrix-vector product, and max-plus products are associative,
so the transfer matrices of whole tiles of steps compose in any order:

  1. **formation**: per tile of ``transfer_tile`` steps, the matrix
     M_tile (F, S, S) — the fused ACS step with the entry-state axis
     folded into the rows, in K3 (``kernels.viterbi_acs.transfer_matrix``)
     or its plain version;
  2. **prefix scan**: every tile's entry metric in O(log2 N) compose
     depth, through ``associative_scan`` over the tropical matmul (K4,
     ``kernels.viterbi_acs.semiring_compose``, on the card; its plain
     version on the CPU);
  3. **recovery**: K1 re-runs every tile at once (tiles folded into the
     frame axis) from its entry metric, writing the survivors;
  4. **traceback**: a reverse scan gives each tile's best metric to the
     end; prefix + suffix pin the survivor path's state at every tile
     boundary, and one traceback over all tiles emits every bit.

The sequential depth is about 2 tiles + O(log2 tiles) steps instead of
T'; the price is S times the formation work, which is why the
auto-selection (``kernel_geometry.time_parallel_plan``) engages only when
frames alone leave the card idle.

``associative_scan`` copies ``jax.lax.associative_scan``'s pairing tree:
the compose quantises its operands to the matmul dtype, so which pairs
are composed decides how the f32 entry metrics round.

The formation and the scans take a ``Semiring``: at ``LOGPROB`` (the
logsumexp compose, K3-LOGPROB) they are the blocked BCJR of
``core/soft.py``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.obs.trace import stage

from .backend import resolve_device
from .kernel_geometry import pick_transfer_tile
from .semiring import TROPICAL, Semiring
from .trellis import AcsTables, CodeSpec, build_acs_tables
from .viterbi import (
    AcsPrecision,
    blocks_from_llrs,
    forward_fused,
    init_metric,
    traceback,
)

__all__ = [
    "associative_scan",
    "tropical_matmul",
    "tropical_identity",
    "tiled_blocks",
    "transfer_matrices",
    "prefix_entry_metrics",
    "entry_from_prefix",
    "transfer_prefix",
    "timeparallel_forward",
    "decode_time_parallel",
]


def associative_scan(fn, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan of ``fn`` along dim 0, with the pairing tree of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the
    pairs, combine each scanned pair with the next even element,
    interleave.  ``reverse`` flips the input and the output, so ``fn``
    then gets the later element as its left operand."""
    with stage("scan", device=x.device):
        if reverse:
            return _scan(fn, x.flip(0)).flip(0)
        return _scan(fn, x)


def _scan(fn, x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if n < 2:
        return x
    odd = _scan(fn, fn(x[0:-1:2], x[1::2]))
    even = fn(odd[:-1] if n % 2 == 0 else odd, x[2::2])
    out = torch.empty_like(x)
    out[0] = x[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def tropical_matmul(
    a: torch.Tensor, b: torch.Tensor, matmul_dtype=torch.float32,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Max-plus compose  C[..., i, j] = max_k A[..., i, k] + B[..., k, j],
    operands quantised to ``matmul_dtype``, sums in f32
    (``Semiring.matmul`` at TROPICAL, K4 unless ``use_kernel=False``)."""
    return TROPICAL.matmul(a, b, matmul_dtype, use_kernel)


def tropical_identity(n_states: int, device=None) -> torch.Tensor:
    """The tropical unit matrix: 0 on the diagonal, -1e9 elsewhere, on
    ``device`` (None is the card)."""
    return TROPICAL.identity(n_states, device)


def tiled_blocks(blocks: torch.Tensor, transfer_tile: int) -> torch.Tensor:
    """(T', F, B) -> (tile, N, F, B) with step t = n*tile + i (a view)."""
    T, F, B = blocks.shape
    if T % transfer_tile:
        raise ValueError(
            f"T'={T} steps not divisible by transfer_tile={transfer_tile}"
        )
    return blocks.reshape(T // transfer_tile, transfer_tile, F, B).permute(
        1, 0, 2, 3
    )


def transfer_matrices(
    blocks: torch.Tensor,  # (T', F, B)
    tables: AcsTables,
    precision: AcsPrecision = AcsPrecision(),
    transfer_tile: Optional[int] = None,
    use_kernel: bool = True,
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Per-tile transfer matrices M (N, F, S, S) of ``semiring``: the
    best path metric (TROPICAL) or the total log-score (LOGPROB, the
    BCJR) from entry state i to exit state j over each tile, normalised
    per (tile, frame) by their max entry (a constant per frame and tile,
    invisible to every argmax downstream and cancelled per boundary in
    the BCJR's LLRs).  ``use_kernel`` (default) forms them in K3 — the
    CUDA kernel on the card, its plain version on the CPU;
    ``use_kernel=False`` runs the plain version directly."""
    transfer_tile = transfer_tile or pick_transfer_tile(blocks.shape[0])
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.viterbi_transfer_matrices(
            blocks, tables, precision, transfer_tile=transfer_tile,
            semiring=semiring.name,
        )
    from repro_torch.kernels.ref import transfer_matrix_ref

    return transfer_matrix_ref(
        blocks.to(precision.channel_dtype).to(torch.float32),
        torch.as_tensor(tables.fused_w, device=blocks.device),
        n_states=tables.n_states,
        n_slots=tables.n_slots,
        transfer_tile=transfer_tile,
        carry_dtype=precision.carry_dtype,
        matmul_dtype=precision.matmul_dtype,
        split_dot=precision.split_dot,
        semiring=semiring.name,
    )


def _compose(
    matmul_dtype,
    semiring: Semiring = TROPICAL,
    flip: bool = False,
    use_kernel: bool = True,
):
    """The semiring matmul as a scan operator, in K4 unless
    ``use_kernel=False``.  A reverse scan hands the later element in as
    the left operand, so ``flip`` swaps the operands to keep the products
    in stream order."""
    if flip:
        return lambda a, b: semiring.matmul(b, a, matmul_dtype, use_kernel)
    return functools.partial(
        semiring.matmul, matmul_dtype=matmul_dtype, use_kernel=use_kernel)


def prefix_entry_metrics(
    m: torch.Tensor,  # (N, F, S, S) tile transfer matrices
    lam0: torch.Tensor,  # (F, S) stream-entry metrics
    matmul_dtype=torch.float32,
    semiring: Semiring = TROPICAL,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Entry metric of every tile, (N, F, S): entry_0 = lam0 and
    entry_p = lam0 (x) (M_0 o ... o M_{p-1}), through one
    ``associative_scan`` of the semiring matmul (K4 unless
    ``use_kernel=False``)."""
    prefix = associative_scan(
        _compose(matmul_dtype, semiring, use_kernel=use_kernel), m)
    return entry_from_prefix(prefix, lam0, semiring)


def entry_from_prefix(
    prefix: torch.Tensor,  # (N, F, S, S) inclusive tile prefix products
    lam0: torch.Tensor,  # (F, S) metrics entering tile 0
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Tile entry metrics (N, F, S) from scanned inclusive prefixes."""
    heads = semiring.sum(lam0[None, :, :, None] + prefix[:-1], dim=-2)
    return torch.cat([lam0[None], heads], dim=0)


def _suffix_to_final(
    m: torch.Tensor,  # (N, F, S, S)
    final_state: torch.Tensor,  # (F,) traceback start state
    matmul_dtype=torch.float32,
    use_kernel: bool = True,
) -> torch.Tensor:
    """v (N, F, S): best metric from state s at the start of tile p to
    ``final_state`` at the stream end — the reverse scan of the same
    matmul, flipped, at the final state's column:
    suffix_p = M_p o ... o M_{N-1}."""
    suffix = associative_scan(
        _compose(matmul_dtype, flip=True, use_kernel=use_kernel), m, reverse=True)
    idx = final_state.to(device=m.device, dtype=torch.int64)
    idx = idx[None, :, None, None].expand(*suffix.shape[:-1], 1)
    return suffix.gather(-1, idx)[..., 0]


def transfer_prefix(
    blocks: torch.Tensor,  # (T', F, B)
    tables: AcsTables,
    precision: AcsPrecision = AcsPrecision(),
    transfer_tile: int = 32,
    use_kernel: bool = True,
    semiring: Semiring = TROPICAL,
) -> torch.Tensor:
    """Inclusive tile prefix products (N, F, S, S): formation and scan,
    the half of ``timeparallel_forward`` that does not depend on lam0,
    for callers that run several forwards over the same blocks."""
    m = transfer_matrices(
        blocks, tables, precision, transfer_tile, use_kernel=use_kernel,
        semiring=semiring,
    )
    return associative_scan(
        _compose(precision.matmul_dtype, semiring, use_kernel=use_kernel), m)


def _recovery(
    blocks: torch.Tensor,
    entry: torch.Tensor,  # (N, F, S) tile entry metrics
    tables: AcsTables,
    precision: AcsPrecision,
    transfer_tile: int,
    use_kernel: bool,
    pack_survivors: bool,
):
    """Re-run every tile at once from its entry metric (K1 over N*F
    frames).  Returns (lam_fin (N, F, S) exit metrics per tile, phis
    (tile, N*F, S | S//16) survivors)."""
    T, F, _ = blocks.shape
    n_tiles = T // transfer_tile
    with stage("recovery", device=blocks.device):
        tiles = tiled_blocks(blocks, transfer_tile)
        lam_fin, phis = forward_fused(
            tiles.reshape(transfer_tile, n_tiles * F, -1),
            entry.reshape(n_tiles * F, -1),
            tables,
            precision,
            use_kernel,
            pack_survivors,
        )
        return lam_fin.reshape(n_tiles, F, -1), phis


def _formation_and_recovery(
    blocks: torch.Tensor,
    lam0: torch.Tensor,
    tables: AcsTables,
    precision: AcsPrecision,
    transfer_tile: int,
    use_kernel: bool,
    pack_survivors: bool,
):
    """Formation, scanned entries and the parallel re-run.  Returns
    (m (N,F,S,S), entry (N,F,S), lam_fin (N,F,S), phis)."""
    m = transfer_matrices(
        blocks, tables, precision, transfer_tile, use_kernel=use_kernel
    )
    entry = prefix_entry_metrics(
        m, lam0, precision.matmul_dtype, use_kernel=use_kernel)
    lam_fin, phis = _recovery(
        blocks, entry, tables, precision, transfer_tile, use_kernel,
        pack_survivors,
    )
    return m, entry, lam_fin, phis


def timeparallel_forward(
    blocks: torch.Tensor,  # (T', F, B)
    lam0: torch.Tensor,  # (F, S)
    tables: AcsTables,
    precision: AcsPrecision = AcsPrecision(),
    transfer_tile: int = 32,
    use_kernel: bool = True,
    pack_survivors: bool = False,
    prefix: Optional[torch.Tensor] = None,
):
    """Plug-compatible ``forward_fused``: (lam_final (F, S) f32, phis
    (T', F, S) int8 or packed int32), with sequential depth
    transfer_tile + O(log2 tiles) instead of T'.  lam_final is the last
    tile's recovery metric.  ``prefix`` (from ``transfer_prefix``) skips
    the formation and the scan."""
    T, F, _ = blocks.shape
    n_tiles = T // transfer_tile
    if prefix is None:
        _, _, lam_fin, phis = _formation_and_recovery(
            blocks, lam0, tables, precision, transfer_tile, use_kernel,
            pack_survivors,
        )
    else:
        entry = entry_from_prefix(prefix, lam0)
        lam_fin, phis = _recovery(
            blocks, entry, tables, precision, transfer_tile, use_kernel,
            pack_survivors,
        )
    w = phis.shape[-1]
    phis_full = phis.reshape(transfer_tile, n_tiles, F, w).permute(
        1, 0, 2, 3
    ).reshape(T, F, w)
    return lam_fin[-1], phis_full


def _decode_tp(
    blocks: torch.Tensor,
    lam0: torch.Tensor,
    tables: AcsTables,
    precision: AcsPrecision,
    transfer_tile: int,
    use_kernel: bool,
    pack_survivors: bool,
    final_state: Optional[int],
) -> torch.Tensor:
    T, F, _ = blocks.shape
    n_tiles = T // transfer_tile
    m, entry, lam_fin, phis = _formation_and_recovery(
        blocks, lam0, tables, precision, transfer_tile, use_kernel,
        pack_survivors,
    )
    if final_state is None:
        fs = lam_fin[-1].argmax(dim=-1)
    else:
        fs = torch.full((F,), final_state, dtype=torch.int64, device=blocks.device)
    # pin the survivor path's state at every tile boundary at once:
    # through state s at the start of tile p, the best full path scores
    # entry_p[s] + (best s -> final_state over the remaining tiles)
    v = _suffix_to_final(m, fs, precision.matmul_dtype, use_kernel)
    starts = (entry + v).argmax(dim=-1)  # (N, F)
    exits = torch.cat([starts[1:], fs[None]], dim=0)
    bits = traceback(phis, exits.reshape(n_tiles * F), tables)
    return bits.reshape(n_tiles, F, transfer_tile * tables.rho).permute(
        1, 0, 2
    ).reshape(F, T * tables.rho)


def decode_time_parallel(
    llrs,
    spec: CodeSpec,
    rho: int = 2,
    initial_state: Optional[int] = 0,
    final_state: Optional[int] = None,
    precision: AcsPrecision = AcsPrecision(),
    transfer_tile: Optional[int] = None,
    use_kernel: bool = True,
    pack_survivors: bool = False,
    device=None,
) -> torch.Tensor:
    """Time-parallel ``decode_frames``: llrs (F, n, beta) -> bits (F, n)
    int32, n divisible by rho, on ``device`` (None is the card).  Same
    contract and survivors as the sequential path, sequential depth
    O(tile + log2 tiles).  ``use_kernel`` runs the formation in K3, the
    scans' compose in K4 and the recovery in K1."""
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    tables = build_acs_tables(spec, rho)
    blocks = blocks_from_llrs(llrs, rho)
    tt = pick_transfer_tile(blocks.shape[0], transfer_tile)
    lam0 = init_metric(llrs.shape[0], spec.n_states, initial_state, device=dev)
    return _decode_tp(
        blocks, lam0, tables, precision, tt, use_kernel, pack_survivors,
        final_state,
    )
