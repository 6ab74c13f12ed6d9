"""Scalar reference Viterbi decoder — a direct transcription of the paper's
Algorithm 1 (forward ACS) and Algorithm 2 (traceback), in numpy.

The correctness oracle for the port, as ``repro.core.viterbi_ref`` is for
the reference.  It is intentionally unoptimized.
"""
from __future__ import annotations

import numpy as np

from .trellis import CodeSpec, build_transitions

__all__ = ["viterbi_decode_ref", "forward_ref", "traceback_ref"]

NEG = -1.0e30


def forward_ref(llrs: np.ndarray, spec: CodeSpec, initial_state=0):
    """Algorithm 1.  llrs: (n, beta) float.  Returns (lam, phi).

    lam: (n, S) path metrics; phi: (n, S) selected predecessor state.
    ``initial_state=None`` starts all states at metric 0 (truncated mode).
    """
    tr = build_transitions(spec)
    n = llrs.shape[0]
    S = spec.n_states
    lam_prev = np.zeros(S)
    if initial_state is not None:
        lam_prev = np.full(S, NEG)
        lam_prev[initial_state] = 0.0
    lam = np.zeros((n, S))
    phi = np.zeros((n, S), dtype=np.int64)
    theta = 1.0 - 2.0 * tr.out_bits  # (S, 2, beta): (-1)^alpha_out
    for t in range(n):
        for j in range(S):
            best, arg = NEG * 2, -1
            for y in range(2):  # two predecessors (paper line 4)
                i = int(tr.prev_state[j, y])
                u = int(tr.prev_bit[j])  # branch input bit == MSB of j
                # Eq. 2: delta = sum_b (-1)^alpha_out[b] * llr[b]
                delta = float(np.dot(theta[i, u], llrs[t]))
                cand = lam_prev[i] + delta
                if cand > best:
                    best, arg = cand, i
            lam[t, j] = best
            phi[t, j] = arg
        lam_prev = lam[t]
    return lam, phi


def traceback_ref(lam, phi, spec: CodeSpec, final_state=None):
    """Algorithm 2.  Returns decoded bits (n,)."""
    n = lam.shape[0]
    out = np.zeros(n, dtype=np.int64)
    j = int(np.argmax(lam[-1])) if final_state is None else int(final_state)
    for t in range(n - 1, -1, -1):
        # decoded bit = branch input into j = MSB of j (Thm 1 proof)
        out[t] = j >> (spec.k - 2)
        j = int(phi[t, j])
    return out


def viterbi_decode_ref(
    llrs: np.ndarray,
    spec: CodeSpec,
    initial_state=0,
    final_state=None,
) -> np.ndarray:
    """Full reference decode: Algorithms 1 + 2."""
    lam, phi = forward_ref(np.asarray(llrs, dtype=np.float64), spec, initial_state)
    return traceback_ref(lam, phi, spec, final_state)
