"""Tail-biting decode: the Wrap-Around Viterbi Algorithm (WAVA).

A tail-biting encoder starts AND ends in the state spelled by the last
k-1 message bits, so the trellis is circular and no rate is lost to tail
bits (LTE TBCC, 36.212 §5.1.3.1).  WAVA (Shao et al., "Two decoding
algorithms for tailbiting codes", IEEE Trans. Comm. 2003) gets within a
hair of ML by iterating the ordinary forward pass on the circular
sequence:

  1. pass 0 starts from uniform metrics (every boundary state equally
     likely);
  2. each later pass wraps around: it starts from the previous pass's
     final path metrics;
  3. after each pass, trace back from the best end state; a path whose
     start state equals its end state is accepted.

Each circulation is one ``forward_fused`` (K1 on the card) or, with
``time_parallel``, one ``timeparallel_forward`` over a transfer prefix
formed once (K3, then K1 per circulation); WAVA adds no kernel.  All
``max_iters`` circulations run, as in the reference, inside one
``wava`` stage (``obs.trace.stage``) that carries their count as
``circulations``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.backend import device_underfill_rows, resolve_device
from repro_torch.core.encoder import tail_bite_state  # noqa: F401  (re-export)
from repro_torch.core.kernel_geometry import time_parallel_plan
from repro_torch.core.timeparallel import timeparallel_forward, transfer_prefix
from repro_torch.core.trellis import AcsTables
from repro_torch.core.viterbi import (
    AcsPrecision,
    blocks_from_llrs,
    forward_fused,
    init_metric,
    traceback_with_state,
)
from repro_torch.obs.trace import stage

__all__ = ["DEFAULT_WAVA_ITERS", "wava_decode", "tail_bite_state"]

DEFAULT_WAVA_ITERS = 4


def wava_decode(
    llrs,
    tables: AcsTables,
    precision: Optional[AcsPrecision] = None,
    use_kernel: bool = False,
    pack_survivors: bool = False,
    max_iters: int = DEFAULT_WAVA_ITERS,
    time_parallel: bool = False,
    transfer_tile: Optional[int] = None,
    device=None,
):
    """Decode (F, n, beta) tail-biting frames on ``device`` (None is the
    card).  Returns (bits (F, n) int32, converged (F,) bool): converged
    where a tail-biting consistent path was found within ``max_iters``
    circulations.  A frame's decisions freeze at its first consistent
    pass; frames that never find one keep their last pass's decisions.

    n must be divisible by tables.rho: the circular trellis has exactly n
    stages, so zero-LLR padding is not information-free here; callers
    with odd n use rho=1 tables (``ViterbiDecoder`` does this).

    ``time_parallel`` swaps each circulation's forward pass for the
    transfer-matrix scan (``timeparallel_forward``: the same metrics and
    survivors), with the formation and the scan, which do not depend on
    the entry metric, done once (``transfer_prefix``).  A
    ``transfer_tile`` given with it is trusted as the caller's plan;
    without one the shared plan decides, and a frame too short to tile
    stays on the sequential scan.
    """
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
    tp_tile = None
    if time_parallel:
        if transfer_tile:
            tp_tile = transfer_tile
        else:
            tp_tile = time_parallel_plan(
                F, blocks.shape[0], tables.n_states, True, None,
                device_underfill_rows(dev),
            )
    prefix = None
    if tp_tile is not None:
        prefix = transfer_prefix(blocks, tables, precision, tp_tile, use_kernel)
    lam = init_metric(F, tables.n_states, None, device=dev)  # uniform prior
    done = torch.zeros(F, dtype=torch.bool, device=dev)
    out = torch.zeros((F, n), dtype=torch.int32, device=dev)
    with stage("wava", device=dev, circulations=max_iters):
        for _ in range(max_iters):
            if tp_tile is not None:
                lam, phis = timeparallel_forward(
                    blocks, lam, tables, precision, tp_tile,
                    use_kernel, pack_survivors, prefix=prefix,
                )
            else:
                lam, phis = forward_fused(
                    blocks, lam, tables, precision, use_kernel, pack_survivors
                )
            fs = lam.argmax(dim=-1)
            start, bits = traceback_with_state(phis, fs, tables)
            consistent = start.to(torch.int64) == fs
            out = torch.where(done[:, None], out, bits)  # freeze once consistent
            done = done | consistent
    return out, done
