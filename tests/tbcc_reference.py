"""Plain maximum-likelihood decoding of tail-biting convolutional codes:
the tier-1 tests' reference for WAVA.

Plain PyTorch, written from 3GPP TS 36.212 section 5.1.3.1 (the LTE
tail-biting convolutional code: K = 7, rate 1/3, G0 = 133, G1 = 171,
G2 = 165 octal).  It imports nothing of ``jax``, ``repro`` or
``repro_torch``, and works its trellis out from the generators alone.

Conventions:

- A generator is a k-bit integer whose most significant bit taps the
  current input bit (the octal values of the standard).
- The encoder state holds the last k - 1 inputs, the newest in its top
  bit.  A tail-biting encoder starts in the state its last k - 1 inputs
  leave (36.212: s_i = c_{K-1-i}), so it ends where it began.
- A channel LLR is positive for bit 0; a path's metric is the
  correlation sum_k (-1)^c_k L_k over all n x beta LLRs of the frame.

The decode: for each of the S = 2^(k-1) start states, the Viterbi
algorithm (radix 2) from that state alone, its path forced to end in the
same state; the best of the S circular paths is the maximum-likelihood
decode.  Among equal potentials the lower predecessor wins, among equal
circular paths the lower start state.  Metrics are renormalised every
step by the frame's maximum over all start and end states, which leaves
every comparison between start states as it was.  A frame is
``open_best`` where its circular path is also the best path of the open
trellis (any start and end state): there WAVA's first circulation finds
it, since the best end state's survivor starts in that same state.

Departures from 36.212:

- Rate matching (section 5.1.4.2: the sub-block interleavers, the
  circular buffer, repetition or puncturing to E bits) is not modelled:
  the LLRs are those of the three mother-code streams d(0), d(1), d(2),
  as after de-rate-matching, on the last axis in that order.
- CRC attachment and its masking by the RNTI (section 5.3.3.2) are
  not modelled: the decoder takes every bit of the block as a message
  bit and checks no CRC.

``dtype``: float32 (the default) and float64 compute as stated;
``torch.bfloat16`` rounds the LLRs and every carried metric to bfloat16,
each step's arithmetic in float32 (the control of a precision check).
"""
from __future__ import annotations

import torch

__all__ = ["LTE_K", "LTE_POLYS", "encode_tailbiting", "path_metric", "ml_decode"]

LTE_K = 7
LTE_POLYS = (0o133, 0o171, 0o165)


def encode_tailbiting(bits: torch.Tensor, k: int = LTE_K, polys=LTE_POLYS) -> torch.Tensor:
    """(F, n) 0/1 message bits -> (F, n, beta) uint8 coded bits, the
    encoder started in the state the last k - 1 bits leave."""
    u = bits.to(torch.uint8)
    n = u.shape[-1]
    if n < k - 1:
        raise ValueError(f"a tail-biting block needs at least {k - 1} bits, got {n}")
    up = torch.cat([u[..., n - (k - 1):], u], dim=-1)  # up[i + k - 1] = u[i]
    out = []
    for g in polys:
        c = torch.zeros_like(u)
        for d in range(k):  # tap d: the input d stages ago
            if (g >> (k - 1 - d)) & 1:
                c ^= up[..., k - 1 - d:k - 1 - d + n]
        out.append(c)
    return torch.stack(out, dim=-1)


def path_metric(llrs: torch.Tensor, bits: torch.Tensor, k: int = LTE_K,
                polys=LTE_POLYS) -> torch.Tensor:
    """(F,) float64: the correlation of the circular path that ``bits``
    encode with the LLRs."""
    coded = encode_tailbiting(bits.to(llrs.device), k, polys)
    sign = 1.0 - 2.0 * coded.to(torch.float64)
    return (sign * llrs.to(torch.float64)).sum(dim=(1, 2))


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(torch.float32)
    return x.to(dtype)


def _trellis(k: int, polys, device):
    """Radix-2 tables: pred (S, 2) the predecessors of each state, sign
    (S, 2, beta) the +-1 of each branch's output bits."""
    S = 1 << (k - 1)
    pred = torch.empty((S, 2), dtype=torch.int64)
    sign = torch.empty((S, 2, len(polys)), dtype=torch.float64)
    for j in range(S):
        u = j >> (k - 2)  # the input that entered state j
        for r in range(2):  # r: the oldest bit of the predecessor, shifted out
            p = ((j << 1) & (S - 1)) | r
            pred[j, r] = p
            reg = (u << (k - 1)) | p
            for b, g in enumerate(polys):
                sign[j, r, b] = -1.0 if bin(reg & g).count("1") & 1 else 1.0
    return pred.to(device), sign.to(device)


def ml_decode(llrs: torch.Tensor, k: int = LTE_K, polys=LTE_POLYS,
              dtype=torch.float32, block_frames: int = 4096):
    """Maximum-likelihood decode of (F, n, beta) tail-biting frames.
    Returns (bits (F, n) int32, metric (F,) float64: the decoded circular
    path's correlation, ``path_metric``; open_best (F,) bool)."""
    F, n, beta = llrs.shape
    if beta != len(polys):
        raise ValueError(f"llrs beta={beta} != {len(polys)} generators")
    dev = llrs.device
    work = torch.float32 if dtype == torch.bfloat16 else dtype
    S = 1 << (k - 1)
    pred, sign = _trellis(k, polys, dev)
    sign = sign.to(work)
    starts = torch.arange(S, device=dev)
    bits = torch.empty((F, n), dtype=torch.int32, device=dev)
    open_best = torch.empty(F, dtype=torch.bool, device=dev)
    for f0 in range(0, F, block_frames):
        x = _round(llrs[f0:f0 + block_frames].to(torch.float32), dtype).to(work)
        C = x.shape[0]
        # lam[c, s0, j]: the best path of frame c from start s0 to state j
        lam = torch.full((C, S, S), -1e9, dtype=work, device=dev)
        lam[:, starts, starts] = 0.0
        phi = torch.empty((n, C, S, S), dtype=torch.uint8, device=dev)
        for t in range(n):
            bm = _round(torch.einsum("cb,jrb->cjr", x[:, t], sign), dtype)  # (C, S, 2)
            pot = _round(lam[:, :, pred] + bm[:, None], dtype)  # (C, S0, S, 2)
            best, arg = pot.max(dim=-1)  # the first of equal maxima
            phi[t] = arg.to(torch.uint8)
            top = best.amax(dim=(1, 2), keepdim=True)
            lam = _round(best - top, dtype)
        circular = lam[:, starts, starts]  # (C, S0): each start's circular path
        s0 = circular.argmax(dim=-1)
        open_best[f0:f0 + C] = circular.amax(dim=-1) >= lam.amax(dim=(1, 2))
        rows = torch.arange(C, device=dev)
        j = s0.clone()
        for t in range(n - 1, -1, -1):
            bits[f0:f0 + C, t] = (j >> (k - 2)).to(torch.int32)
            r = phi[t, rows, s0, j].to(torch.int64)
            j = pred[j, r]
        if not torch.equal(j, s0):
            raise AssertionError("a circular path did not return to its start state")
    return bits, path_metric(llrs, bits, k, polys), open_best
