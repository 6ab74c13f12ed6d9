"""Plain reference for convolutional codes: the yardstick that decides
``correct``.

Plain PyTorch, written from the standards' definitions and the decode
semantics stated in each configuration file.  It imports nothing of the
program under test and nothing of the JAX package, and it works every
table out again from a configuration's generators and puncture mask.

Conventions (those of the configurations' ``code`` block):

- A generator is a k-bit integer whose most significant bit taps the
  current input bit (the octal values printed in the standards).
- The encoder state holds the last k - 1 inputs, the newest in its top
  bit; the encoder starts in state 0.
- A channel LLR is positive for bit 0; a branch metric is the
  correlation sum_k (-1)^c_k L_k.
- The radix-2^rho trellis: state j at the end of a step is reached from
  the R = 2^rho predecessors p(j, r) = ((j & (S/R - 1)) << rho) | r,
  r the slot; the step's rho inputs are the top rho bits of j, the
  earliest in the lowest of them.  Among equal potentials the lowest
  slot wins, among equal metrics the lowest state.

Decoders:

- ``window_decode``: the tiled stream decode.  Each stream is padded
  with ``overlap`` zero-LLR stages on each side and cut into windows of
  ``frame_len + 2 overlap`` stages that start every ``frame_len``; each
  window runs the forward pass from a uniform metric, with the metrics
  renormalised by their maximum every step.  After every ``tile_steps``
  steps (e) it traces back from the best state and decides the steps
  [e - depth_steps - tile_steps, e - depth_steps); each window keeps its
  centre ``frame_len`` stages.  ``depth_steps = 0`` with one tile over
  the window is the plain decode of a whole window from its best end
  state.  In float32 the branch metric is summed in k order from 0 and
  each potential is one add of it and the predecessor's metric, so that
  every value is the one IEEE float32 arithmetic gives in that order.
- ``path_gap``: how far a decoded path's metric lies below the best
  (maximum likelihood) path's, in float64, from a known start state and
  over every end state.
- ``viterbi_decode``: the full-trellis decode of frames from a known
  start state with a traceback from the best end state.
- ``bcjr_llrs``: the log-MAP per-bit LLRs of frames from a known start
  state with a free end (the exact forward-backward recursion, branch
  log-likelihoods (-1)^c . L / 2).

Every decoder takes ``dtype``.  float32 and float64 are computed as
stated; ``torch.bfloat16`` is the control: the LLRs and every carried
metric rounded to bfloat16, a step's arithmetic in float32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "Trellis", "encode", "puncture", "depuncture", "window_decode",
    "path_gap", "viterbi_decode", "bcjr_llrs",
]


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


class Trellis:
    """The radix-2^rho trellis of a rate-1/beta convolutional code."""

    def __init__(self, k: int, polys, rho: int = 2):
        if not 1 <= rho <= k - 1:
            raise ValueError(f"rho must be in [1, k-1], got {rho}")
        self.k, self.polys, self.rho = int(k), tuple(int(g) for g in polys), int(rho)
        self.beta = len(self.polys)
        self.S = 1 << (self.k - 1)
        self.R = 1 << self.rho
        self.B = self.rho * self.beta
        self.shift = self.k - 1 - self.rho
        self.mask = (1 << self.shift) - 1
        # theta[b, j, r]: (-1)^(output bit b) of the super-branch p(j, r) -> j,
        # the rho stages' outputs stage-major
        theta = [[[0.0] * self.R for _ in range(self.S)] for _ in range(self.B)]
        for j in range(self.S):
            bits = [(j >> (self.shift + i)) & 1 for i in range(self.rho)]
            for r in range(self.R):
                s = ((j & self.mask) << self.rho) | r
                out = []
                for u in bits:
                    reg = (u << (self.k - 1)) | s
                    out.extend(_parity(reg & g) for g in self.polys)
                    s = (u << (self.k - 2)) | (s >> 1)
                if s != j:
                    raise AssertionError("super-branch does not end in its state")
                for b, c in enumerate(out):
                    theta[b][j][r] = -1.0 if c else 1.0
        self.theta = torch.tensor(theta, dtype=torch.float64)  # (B, S, R)
        # the distinct columns of theta, and each (j, r)'s column
        cols = self.theta.reshape(self.B, -1).T
        self.cols, self.cid = torch.unique(cols, dim=0, return_inverse=True)
        self.cols = self.cols.T.contiguous()  # (B, n_u)


def encode(bits: torch.Tensor, k: int, polys, tail_biting: bool = False) -> torch.Tensor:
    """(F, n) 0/1 inputs -> (F, n, beta) coded bits (uint8), from state 0,
    or with ``tail_biting`` from the state the last k - 1 inputs leave."""
    u = bits.to(torch.uint8)
    n = u.shape[-1]
    if tail_biting:
        up = torch.cat([u[..., n - (k - 1):], u], dim=-1)
    else:
        up = torch.nn.functional.pad(u, (k - 1, 0))
    out = []
    for g in polys:
        c = torch.zeros_like(u)
        for d in range(k):
            if (g >> (k - 1 - d)) & 1:
                c ^= up[..., k - 1 - d:k - 1 - d + n]
        out.append(c)
    return torch.stack(out, dim=-1)


def _kept_positions(mask, n: int, device) -> torch.Tensor:
    m = torch.tensor(mask, dtype=torch.bool, device=device)
    reps = -(-n // m.shape[0])
    return torch.nonzero(m.repeat(reps, 1)[:n].reshape(-1)).reshape(-1)


def puncture(coded: torch.Tensor, mask) -> torch.Tensor:
    """(F, n, beta) -> (F, Lp): the kept entries, stage-major."""
    F, n, beta = coded.shape
    return coded.reshape(F, n * beta)[:, _kept_positions(mask, n, coded.device)]


def depuncture(kept: torch.Tensor, mask, n: int) -> torch.Tensor:
    """(F, Lp) kept LLRs -> (F, n, beta) with zero LLRs where punctured."""
    F = kept.shape[0]
    beta = len(mask[0])
    idx = _kept_positions(mask, n, kept.device)
    if idx.numel() != kept.shape[1]:
        raise ValueError(f"{kept.shape[1]} kept LLRs do not fill {n} stages")
    out = torch.zeros((F, n * beta), dtype=kept.dtype, device=kept.device)
    out[:, idx] = kept
    return out.reshape(F, n, beta)


def _blocks(llrs: torch.Tensor, rho: int) -> torch.Tensor:
    """(F, n, beta) -> (T, F, rho * beta), n a multiple of rho."""
    F, n, beta = llrs.shape
    if n % rho:
        raise ValueError(f"{n} stages are not a multiple of rho={rho}")
    return llrs.reshape(F, n // rho, rho * beta).transpose(0, 1)


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in the working type of ``dtype``: bfloat16 values held in float32."""
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(torch.float32)
    return x.to(dtype)


def _work_dtype(dtype):
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _branch_metrics(blocks: torch.Tensor, tr: Trellis, dtype) -> torch.Tensor:
    """(..., B) LLRs -> (..., n_u) branch metrics of the distinct columns,
    summed in k order from 0 (each term's product by +-1 is exact), each
    sum rounded to ``dtype``."""
    cols = tr.cols.to(device=blocks.device, dtype=blocks.dtype)
    bm = torch.zeros(blocks.shape[:-1] + (cols.shape[1],), dtype=blocks.dtype,
                     device=blocks.device)
    for b in range(tr.B):
        bm = _round(bm + blocks[..., b:b + 1] * cols[b], dtype)
    return bm


def _potentials(bm: torch.Tensor, lam: torch.Tensor, tr: Trellis, dtype) -> torch.Tensor:
    """(rows, n_u) branch metrics and (rows, S) metrics -> (rows, S, R)
    potentials bm(j, r) + lam[p(j, r)], rounded to ``dtype``."""
    rows = lam.shape[0]
    hi = tr.S // (tr.mask + 1)  # states sharing one set of predecessors
    b = bm[:, tr.cid.to(bm.device)].view(rows, hi, tr.mask + 1, tr.R)
    return _round(b + lam.view(rows, 1, tr.mask + 1, tr.R), dtype).view(rows, tr.S, tr.R)


def _step_bits(state: torch.Tensor, tr: Trellis) -> torch.Tensor:
    """The rho decided bits (chronological) of the steps ending in ``state``."""
    v = state >> tr.shift
    return torch.stack([(v >> i) & 1 for i in range(tr.rho)], dim=-1)


def _pred(state: torch.Tensor, slot: torch.Tensor, tr: Trellis) -> torch.Tensor:
    return ((state & tr.mask) << tr.rho) | slot


def window_decode(
    llrs: torch.Tensor,  # (N, n, beta) depunctured stream LLRs
    tr: Trellis,
    frame_len: int,
    overlap: int,
    depth_steps: int,
    tile_steps: Optional[int],
    dtype=torch.float32,
    max_windows: int = 1 << 17,
) -> torch.Tensor:
    """The tiled stream decode (module docstring).  ``tile_steps`` None is
    one tile over the whole window.  Returns (N, n) int32 bits."""
    N, n, beta = llrs.shape
    f, v, rho = frame_len, overlap, tr.rho
    if f % rho or v % rho:
        raise ValueError("frame_len and overlap must be multiples of rho")
    n_win = -(-n // f)
    W = f + 2 * v
    T = W // rho
    tt = T if tile_steps is None else tile_steps
    if T % tt:
        raise ValueError(f"tile of {tt} steps does not divide a window of {T}")
    c0, c1 = v // rho, (v + f) // rho  # the centre's steps
    # decision points e and the steps [a, b) each decides inside the centre
    plan = []
    for e in range(tt, T + 1, tt):
        a, b = max(e - depth_steps - tt, c0), min(e - depth_steps, c1)
        if a < b:
            plan.append((e, a, b))
    if sorted(s for _, a, b in plan for s in range(a, b)) != list(range(c0, c1)):
        raise ValueError("the decision plan does not cover the centre once")
    dev = llrs.device
    work = _work_dtype(dtype)
    padded = torch.zeros((N, n_win * f + 2 * v, beta), dtype=torch.float32, device=dev)
    padded[:, v:v + n] = llrs.to(torch.float32)
    windows = padded.unfold(1, W, f).permute(0, 1, 3, 2).reshape(N * n_win, W, beta)
    out = torch.empty((N * n_win, f), dtype=torch.int32, device=dev)
    for w0 in range(0, N * n_win, max_windows):
        blocks = _round(_blocks(windows[w0:w0 + max_windows], rho), dtype)
        C = blocks.shape[1]
        bm = _branch_metrics(blocks, tr, dtype)  # every step's at once
        lam = torch.zeros((C, tr.S), dtype=work, device=dev)
        phi = torch.empty((T, C, tr.S), dtype=torch.uint8, device=dev)
        best_at = {}
        for t in range(T):
            pot = _potentials(bm[t], lam, tr, dtype)
            best, arg = pot.max(dim=-1)  # the first of equal maxima
            phi[t] = arg.to(torch.uint8)
            lam = _round(best - best.amax(dim=-1, keepdim=True), dtype)
            if (t + 1) % tt == 0:
                best_at[t + 1] = lam.argmax(dim=-1)
        bits = torch.empty((C, T, rho), dtype=torch.int32, device=dev)
        for e, a, b in plan:
            state = best_at[e]
            for t in range(e - 1, a - 1, -1):
                if t < b:
                    bits[:, t] = _step_bits(state, tr).to(torch.int32)
                slot = phi[t].gather(1, state[:, None])[:, 0].to(torch.int64)
                state = _pred(state, slot, tr)
        out[w0:w0 + C] = bits[:, c0:c1].reshape(C, f)
        del phi, blocks, bm
    return out.reshape(N, n_win * f)[:, :n]


def path_gap(
    llrs: torch.Tensor,  # (F, n, beta)
    bits: torch.Tensor,  # (F, n) a decoded path's inputs
    tr: Trellis,
    k: int,
    initial_state: int = 0,
    chunk_steps: int = 2048,
) -> torch.Tensor:
    """(F,) float64: the best path's metric (from ``initial_state``, any end
    state) less the metric of the path that ``bits`` encode."""
    if initial_state != 0:
        raise ValueError("the path score assumes the encoder's start state 0")
    llrs = llrs.to(torch.float64)
    dev = llrs.device
    coded = encode(bits, k, tr.polys)
    score = ((1.0 - 2.0 * coded.to(torch.float64)) * llrs).sum(dim=(1, 2))
    blocks = _blocks(llrs, tr.rho)
    T, F, _ = blocks.shape
    theta = tr.theta.reshape(tr.B, -1).to(dev)  # (B, S*R)
    hi = tr.S // (tr.mask + 1)
    lam = torch.full((F, tr.S), -math.inf, dtype=torch.float64, device=dev)
    lam[:, initial_state] = 0.0
    for t0 in range(0, T, chunk_steps):
        bm = (blocks[t0:t0 + chunk_steps] @ theta).view(-1, F, hi, tr.mask + 1, tr.R)
        for t in range(bm.shape[0]):
            lam = (bm[t] + lam.view(F, 1, tr.mask + 1, tr.R)).amax(dim=-1).view(F, tr.S)
    return lam.amax(dim=-1) - score


def viterbi_decode(
    llrs: torch.Tensor,  # (F, n, beta)
    tr: Trellis,
    initial_state: int = 0,
    dtype=torch.float32,
    chunk_steps: int = 16384,
) -> torch.Tensor:
    """Full-trellis decode from ``initial_state``, traced back from the
    best end state, metrics renormalised every step.  (F, n) int32."""
    blocks = _round(_blocks(llrs.to(torch.float32), tr.rho), dtype)
    T, F, _ = blocks.shape
    dev = llrs.device
    work = _work_dtype(dtype)
    lam = torch.full((F, tr.S), -1e9, dtype=work, device=dev)
    lam[:, initial_state] = 0.0
    phi = torch.empty((T, F, tr.S), dtype=torch.uint8, device=dev)
    for t0 in range(0, T, chunk_steps):
        bm = _branch_metrics(blocks[t0:t0 + chunk_steps], tr, dtype)
        for i in range(bm.shape[0]):
            best, arg = _potentials(bm[i], lam, tr, dtype).max(dim=-1)
            phi[t0 + i] = arg.to(torch.uint8)
            lam = _round(best - best.amax(dim=-1, keepdim=True), dtype)
    state = lam.argmax(dim=-1)
    bits = torch.empty((F, T, tr.rho), dtype=torch.int32, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = _step_bits(state, tr).to(torch.int32)
        state = _pred(state, phi[t].gather(1, state[:, None])[:, 0].to(torch.int64), tr)
    return bits.reshape(F, T * tr.rho)


def bcjr_llrs(
    llrs: torch.Tensor,  # (F, n, beta)
    tr: Trellis,
    initial_state: int = 0,
    dtype=torch.float64,
    chunk_steps: int = 1024,
) -> torch.Tensor:
    """Log-MAP per-bit LLRs (F, n), positive for bit 0, in ``dtype``'s
    working type: the forward and backward recursions over the branch
    log-likelihoods (-1)^c . L / 2, from ``initial_state`` to a free end."""
    work = _work_dtype(dtype)
    blocks = _round(_blocks(llrs.to(torch.float32), tr.rho), dtype)
    T, F, _ = blocks.shape
    dev = llrs.device
    theta = tr.theta.reshape(tr.B, -1).to(device=dev, dtype=work)  # (B, S*R)
    hi, lo = tr.S // (tr.mask + 1), tr.mask + 1
    renorm = dtype == torch.bfloat16

    def gamma(t0, t1):
        g = 0.5 * (blocks[t0:t1].to(work) @ theta)
        return _round(g, dtype).view(t1 - t0, F, hi, lo, tr.R)

    # joint[t] = alpha + beta at the boundary after step t
    joint = torch.empty((T, F, tr.S), dtype=work, device=dev)
    alpha = torch.full((F, tr.S), -math.inf, dtype=work, device=dev)
    alpha[:, initial_state] = 0.0
    for t0 in range(0, T, chunk_steps):
        g = gamma(t0, min(T, t0 + chunk_steps))
        for i in range(g.shape[0]):
            alpha = torch.logsumexp(g[i] + alpha.view(F, 1, lo, tr.R), dim=-1).view(F, tr.S)
            if renorm:
                alpha = alpha - alpha.amax(dim=-1, keepdim=True)
            alpha = _round(alpha, dtype)
            joint[t0 + i] = alpha
    beta = torch.zeros((F, tr.S), dtype=work, device=dev)
    for t1 in range(T, 0, -chunk_steps):
        t0 = max(0, t1 - chunk_steps)
        g = gamma(t0, t1)
        for i in range(g.shape[0] - 1, -1, -1):
            joint[t0 + i] += beta
            # beta before step t: over the R successors j = (h, p >> rho) of p
            beta = torch.logsumexp(g[i] + beta.view(F, hi, lo, 1), dim=1).reshape(F, tr.S)
            if renorm:
                beta = beta - beta.amax(dim=-1, keepdim=True)
            beta = _round(beta, dtype)
    # step t's bit i is bit shift + i of the state at the boundary after t
    j = torch.arange(tr.S, device=dev)
    out = torch.empty((F, T, tr.rho), dtype=work, device=dev)
    for i in range(tr.rho):
        one = ((j >> (tr.shift + i)) & 1).bool()
        for t0 in range(0, T, chunk_steps):
            jt = joint[t0:t0 + chunk_steps]
            llr = torch.logsumexp(jt[..., ~one], dim=-1) - torch.logsumexp(jt[..., one], dim=-1)
            out[:, t0:t0 + chunk_steps, i] = llr.T
    return out.reshape(F, T * tr.rho)
