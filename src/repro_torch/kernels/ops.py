"""Public kernel wrappers bound to ``core.viterbi``.

``viterbi_forward`` is plug-compatible with ``core.viterbi.forward_fused``
and is selected there by ``use_kernel=True``: the two-pass path, with the
full survivor tensor written out and a plain PyTorch traceback after it.
"""
from __future__ import annotations

import torch

from repro_torch.core.trellis import AcsTables
from repro_torch.core.viterbi import AcsPrecision

from .viterbi_acs import acs_forward

__all__ = ["viterbi_forward"]


def viterbi_forward(
    blocks: torch.Tensor,  # (T, F, B)
    lam0: torch.Tensor,  # (F, S)
    tables: AcsTables,
    precision=None,
    *,
    pack_survivors: bool = False,
    semiring: str = "tropical",
):
    """K1-backed fused forward.

    Returns (lam (F,S) f32, phi) with phi (T, F, S) int8 slot indices, or
    (T, F, S//16) int32 PACKED words when ``pack_survivors`` —
    ``core.viterbi.traceback`` reads the packed words as they are.
    """
    precision = precision or AcsPrecision()
    w = torch.as_tensor(tables.fused_w, device=blocks.device)
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
    )
