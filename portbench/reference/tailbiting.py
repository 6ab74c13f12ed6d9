"""Plain reference for tail-biting codes: the maximum-likelihood decode
of a circular trellis and the wrap-around Viterbi decode, the yardsticks
that decide ``correct`` in the ``lte-tbcc`` cells.

Plain PyTorch, written from 3GPP TS 36.212 section 5.1.3.1 (the LTE
tail-biting convolutional code: K = 7, rate 1/3, G0 = 133, G1 = 171,
G2 = 165 octal; the shift register starts in the state the block's last
six bits leave, s_i = c_{K-1-i}, so it ends where it began).  It imports
nothing of the program and nothing of the JAX package; the trellis and
its conventions are ``conv``'s (its module docstring).

``ml_decode``: for each of the S start states, the Viterbi algorithm
from that state alone over the radix-2^rho trellis, the path forced to
end in the same state; the best of the S circular paths is the
maximum-likelihood decode.  Among equal potentials the lowest slot wins,
among equal circular paths the lowest start state.  The metrics are
renormalised every step by the frame's maximum over every start and end
state, which leaves each comparison between start states as it was.
Frames are decoded in blocks of ``block_frames``, so that the survivors
of every start state fit on the card.

``wava_decode``: the wrap-around Viterbi algorithm (Shao, Lin and
Fossorier, "Two decoding algorithms for tailbiting codes", IEEE Trans.
Commun. 51(10), 2003) as the program states it: a first pass of the
Viterbi algorithm from uniform metrics, each later pass from the
previous pass's final metrics (renormalised every step by the frame's
maximum), after each pass a traceback from the best end state; a
frame's bits freeze at the first pass whose path starts in the state it
ends in, and a frame that finds none keeps its last pass's bits.  Only
the best end state's path is checked, so WAVA departs from the
maximum-likelihood decode where the best path of the open trellis (any
start, any end state) is not circular: its end then wins every pass.
Where that path is circular, the first pass finds it and both agree.

Departures from 36.212:

- Rate matching (section 5.1.4.2: the sub-block interleavers, the
  circular buffer, repetition or puncturing to E bits) is not modelled:
  the LLRs are those of the three mother-code streams d(0), d(1), d(2),
  as after de-rate-matching, on the last axis in that order.
- CRC attachment and its masking by the RNTI (section 5.3.3.2) are not
  modelled: every bit of the block is a message bit and no CRC is
  checked.

``dtype``: float32 (the default) and float64 compute as stated;
``torch.bfloat16`` is the control: the LLRs and every carried metric
rounded to bfloat16, each step's arithmetic in float32.
"""
from __future__ import annotations

import torch

from portbench.reference.conv import (
    Trellis,
    _blocks,
    _branch_metrics,
    _potentials,
    _pred,
    _round,
    _step_bits,
    _work_dtype,
)

__all__ = ["ml_decode", "wava_decode"]


def ml_decode(llrs: torch.Tensor, tr: Trellis, dtype=torch.float32,
              block_frames: int = 8192) -> torch.Tensor:
    """Maximum-likelihood decode of (F, n, beta) tail-biting frames, n a
    multiple of rho.  Returns (F, n) int32 bits."""
    blocks = _blocks(llrs.to(torch.float32), tr.rho)  # (T, F, B)
    T, F, _ = blocks.shape
    dev = llrs.device
    work = _work_dtype(dtype)
    S, R, lo = tr.S, tr.R, tr.mask + 1
    hi = S // lo
    cid = tr.cid.to(dev)
    starts = torch.arange(S, device=dev)
    bits = torch.empty((F, T, tr.rho), dtype=torch.int32, device=dev)
    for f0 in range(0, F, block_frames):
        bm = _branch_metrics(_round(blocks[:, f0:f0 + block_frames], dtype), tr, dtype)
        C = bm.shape[1]
        # lam[c, s0, j]: the best path of frame c from start s0 to state j
        lam = torch.full((C, S, S), -1e9, dtype=work, device=dev)
        lam[:, starts, starts] = 0.0
        phi = torch.empty((T, C, S, S), dtype=torch.uint8, device=dev)
        for t in range(T):
            b = bm[t][:, cid].view(C, 1, hi, lo, R)
            pot = _round(b + lam.view(C, S, 1, lo, R), dtype).view(C, S, S, R)
            best, arg = pot.max(dim=-1)  # the first of equal maxima
            phi[t] = arg.to(torch.uint8)
            lam = _round(best - best.amax(dim=(1, 2), keepdim=True), dtype)
        s0 = lam[:, starts, starts].argmax(dim=-1)  # the best circular path's start
        rows = torch.arange(C, device=dev)
        state = s0.clone()
        for t in range(T - 1, -1, -1):
            bits[f0:f0 + C, t] = _step_bits(state, tr).to(torch.int32)
            slot = phi[t, rows, s0, state].to(torch.int64)
            state = _pred(state, slot, tr)
        if not torch.equal(state, s0):
            raise AssertionError("a circular path did not return to its start state")
        del phi, bm
    return bits.reshape(F, T * tr.rho)


def wava_decode(llrs: torch.Tensor, tr: Trellis, circulations: int = 4,
                dtype=torch.float32, block_frames: int = 65536) -> torch.Tensor:
    """The wrap-around Viterbi decode (module docstring) of (F, n, beta)
    tail-biting frames, n a multiple of rho, with ``circulations`` passes.
    Returns (F, n) int32 bits."""
    blocks = _blocks(llrs.to(torch.float32), tr.rho)  # (T, F, B)
    T, F, _ = blocks.shape
    dev = llrs.device
    out = torch.empty((F, T, tr.rho), dtype=torch.int32, device=dev)
    for f0 in range(0, F, block_frames):
        bm = _branch_metrics(_round(blocks[:, f0:f0 + block_frames], dtype), tr, dtype)
        C = bm.shape[1]
        lam = torch.zeros((C, tr.S), dtype=_work_dtype(dtype), device=dev)  # uniform
        phi = torch.empty((T, C, tr.S), dtype=torch.uint8, device=dev)
        done = torch.zeros(C, dtype=torch.bool, device=dev)
        bits = torch.zeros((C, T, tr.rho), dtype=torch.int32, device=dev)
        step_bits = torch.empty_like(bits)
        for _ in range(circulations):
            for t in range(T):
                best, arg = _potentials(bm[t], lam, tr, dtype).max(dim=-1)  # first of equal maxima
                phi[t] = arg.to(torch.uint8)
                lam = _round(best - best.amax(dim=-1, keepdim=True), dtype)
            end = lam.argmax(dim=-1)
            state = end
            for t in range(T - 1, -1, -1):
                step_bits[:, t] = _step_bits(state, tr).to(torch.int32)
                slot = phi[t].gather(1, state[:, None])[:, 0].to(torch.int64)
                state = _pred(state, slot, tr)
            bits = torch.where(done[:, None, None], bits, step_bits)
            done = done | (state == end)
        out[f0:f0 + C] = bits
        del phi, bm
    return out.reshape(F, T * tr.rho)
