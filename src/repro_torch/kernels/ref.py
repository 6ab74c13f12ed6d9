"""Plain PyTorch version of K1 (``viterbi_acs.acs_forward``): the same
contract, one radix step at a time.

``acs_forward`` runs this for CPU tensors; the tests hold it against the
reference's Pallas kernel, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.  It repeats the kernel's arithmetic and is no
yardstick of speed.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernel_geometry import (
    check_packable,
    pack_slots,
    ring_dtype,
    ring_words,
)
from repro_torch.core.viterbi import dot_f32

__all__ = ["acs_forward_ref"]


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
):
    """Returns (lam_final (F, S) f32, phi (T, F, S) int8 or packed
    (T, F, S//16) int32).  Per step: x = [L_t | Lambda] rounded to
    ``matmul_dtype``, pot = x @ W in f32, Lambda' = slot max, phi = first
    slot argmax, optional per-frame max subtraction, carry rounded to
    ``carry_dtype``."""
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
        new = pot.amax(dim=-1)
        phi = pot.argmax(dim=-1)
        phis[t] = pack_slots(phi, R) if pack_survivors else phi
        if renorm:
            new = new - new.amax(dim=-1, keepdim=True)
        lam = new.to(carry_dtype)
    return lam.to(torch.float32), phis
