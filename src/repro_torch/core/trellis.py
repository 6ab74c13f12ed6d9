"""Convolutional-code trellis structure (paper §II, §IV, §VII), in numpy.

Conventions (paper Fig. 1, Eq. 1), the same as the reference's:
  * state s at time t = previous k-1 input bits, most recent at the MSB;
  * transition on input bit u:  next = (u << (k-2)) | (s >> 1);
  * output bit b = parity( ((u << (k-1)) | s) & poly_b ).

The fused ACS tables below are the decoder's only "parameters": the
stacked operand W = [theta_t ; pred_onehot] of the per-step matmul.
``tables_from_numpy`` rebuilds them from arrays made elsewhere (for
example by the JAX reference), so the two packages can be held to the
same tables.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence

import numpy as np

__all__ = [
    "CodeSpec",
    "CODE_K7_CCSDS",
    "Transitions",
    "AcsTables",
    "build_transitions",
    "build_acs_tables",
    "superbranch_output_bits",
    "tables_from_numpy",
]


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A (beta, 1, k) convolutional code: rate 1/beta, constraint length k."""

    k: int
    polys: tuple  # beta generator polynomials, k-bit ints (octal in papers)

    def __post_init__(self):
        # coerce to a hashable tuple of ints: specs key lru_caches
        object.__setattr__(self, "polys", tuple(int(g) for g in self.polys))
        if self.k < 2:
            raise ValueError(f"constraint length k must be >= 2, got {self.k}")
        if len(self.polys) < 2:
            raise ValueError(
                f"need beta >= 2 generator polynomials, got {len(self.polys)}"
            )
        for g in self.polys:
            if not 0 < g < (1 << self.k):
                raise ValueError(f"polynomial {g:o} (octal) not a {self.k}-bit value")

    @property
    def beta(self) -> int:
        return len(self.polys)

    @property
    def rate(self) -> float:
        return 1.0 / self.beta

    @property
    def n_states(self) -> int:
        return 1 << (self.k - 1)


# The paper's experimental code (§IX-A): (2,1,7), polys 171/133 octal.
CODE_K7_CCSDS = CodeSpec(k=7, polys=(0o171, 0o133))


def _parity(x: np.ndarray) -> np.ndarray:
    """Bitwise parity of each element (vectorized popcount & 1)."""
    x = np.asarray(x, dtype=np.uint64)
    out = np.zeros_like(x)
    while np.any(x):
        out ^= x & 1
        x >>= np.uint64(1)
    return out.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Transitions:
    """Dense FSM tables.

    next_state[s, u]  : state reached from s on input u.
    out_bits[s, u, b] : output bit b on that branch (0/1).
    prev_state[j, y]  : the y-th predecessor of j (y = LSB of predecessor).
    prev_bit[j]       : the input bit taken on ANY branch into j (= MSB of j).
    """

    next_state: np.ndarray
    out_bits: np.ndarray
    prev_state: np.ndarray
    prev_bit: np.ndarray


@functools.lru_cache(maxsize=64)
def build_transitions(spec: CodeSpec) -> Transitions:
    S, k = spec.n_states, spec.k
    s = np.arange(S)[:, None]
    u = np.arange(2)[None, :]
    next_state = (u << (k - 2)) | (s >> 1)
    reg = (u << (k - 1)) | s
    out_bits = np.stack(
        [_parity(reg & g) for g in spec.polys], axis=-1
    )  # (S, 2, beta)
    j = np.arange(S)[:, None]
    y = np.arange(2)[None, :]
    mask = (1 << (k - 2)) - 1
    prev_state = ((j & mask) << 1) | y
    prev_bit = (np.arange(S) >> (k - 2)).astype(np.int64)  # MSB of j
    return Transitions(next_state, out_bits, prev_state, prev_bit)


def superbranch_output_bits(
    spec: CodeSpec, state: int, in_bits: Sequence[int]
) -> list:
    """Output bits of a length-rho path (super-branch, §VII) from `state`:
    rho*beta bits, stage-major (Eq. 33's summation order)."""
    tr = build_transitions(spec)
    out = []
    s = state
    for u in in_bits:
        out.extend(int(b) for b in tr.out_bits[s, u])
        s = int(tr.next_state[s, u])
    return out


@dataclasses.dataclass(frozen=True, eq=False)  # arrays: compare by identity
class AcsTables:
    """Tables for the fused radix-2^rho ACS step.

    With F frames, S states, R = 2^rho slots, B = rho*beta LLR entries:

        potentials = [L | Lambda] @ W           # (F, B+S) @ (B+S, S*R)
        Lambda'    = max_slot  potentials.reshape(F, S, R)
        phi        = argmax_slot ...

    where W = [theta_t ; pred_onehot].  Column (j*R + slot) of theta_t
    holds the +-1 super-branch output pattern into state j from its
    slot-th predecessor (Eq. 33); pred_onehot[i, (j, slot)] = 1 iff
    i = pred(j, slot) = ((j & mask) << rho) | slot.
    """

    spec: CodeSpec
    rho: int
    theta_t: np.ndarray  # (rho*beta, S*R) float32, +-1
    pred_onehot: np.ndarray  # (S, S*R) float32, one-hot
    pred_state: np.ndarray  # (S, R) int32
    dec_bits: np.ndarray  # (S, rho) int32 — decoded bits (chronological) of j

    @property
    def n_states(self) -> int:
        return self.spec.n_states

    @property
    def n_slots(self) -> int:
        return 1 << self.rho

    @property
    def llr_block(self) -> int:
        return self.rho * self.spec.beta

    @property
    def fused_w(self) -> np.ndarray:
        """The stacked (B+S, S*R) operand of the fused matmul."""
        return np.concatenate([self.theta_t, self.pred_onehot], axis=0)


def _check_rho(spec: CodeSpec, rho: int) -> None:
    if not 1 <= rho <= spec.k - 1:
        raise ValueError(f"rho must be in [1, k-1], got {rho}")


@functools.lru_cache(maxsize=64)
def build_acs_tables(spec: CodeSpec, rho: int = 2) -> AcsTables:
    _check_rho(spec, rho)
    k, S = spec.k, spec.n_states
    R = 1 << rho
    B = rho * spec.beta
    mask = (1 << (k - 1 - rho)) - 1

    theta_t = np.zeros((B, S * R), dtype=np.float32)
    pred_onehot = np.zeros((S, S * R), dtype=np.float32)
    pred_state = np.zeros((S, R), dtype=np.int32)
    dec_bits = np.zeros((S, rho), dtype=np.int32)

    for j in range(S):
        v = j >> (k - 1 - rho)  # the rho most-recent input bits
        in_bits = [(v >> b) & 1 for b in range(rho)]  # chronological
        dec_bits[j] = in_bits
        for slot in range(R):
            pred = ((j & mask) << rho) | slot
            pred_state[j, slot] = pred
            col = j * R + slot
            bits = superbranch_output_bits(spec, pred, in_bits)
            theta_t[:, col] = [(-1.0) ** b for b in bits]
            pred_onehot[pred, col] = 1.0

    return AcsTables(
        spec=spec,
        rho=rho,
        theta_t=theta_t,
        pred_onehot=pred_onehot,
        pred_state=pred_state,
        dec_bits=dec_bits,
    )


_TABLE_DTYPES = {
    "theta_t": np.float32,
    "pred_onehot": np.float32,
    "pred_state": np.int32,
    "dec_bits": np.int32,
}


def tables_from_numpy(
    spec: CodeSpec, rho: int, arrays: Dict[str, np.ndarray]
) -> AcsTables:
    """Build ``AcsTables`` from arrays made elsewhere, e.g. the fields of
    the JAX reference's tables.  ``arrays`` holds ``theta_t``,
    ``pred_onehot``, ``pred_state`` and ``dec_bits``, and may hold
    ``fused_w``, which must then equal their stack.  Shapes are checked
    against (spec, rho); values are taken as given."""
    _check_rho(spec, rho)
    S, R, B = spec.n_states, 1 << rho, rho * spec.beta
    shapes = {
        "theta_t": (B, S * R),
        "pred_onehot": (S, S * R),
        "pred_state": (S, R),
        "dec_bits": (S, rho),
    }
    missing = sorted(set(shapes) - set(arrays))
    if missing:
        raise ValueError(f"tables_from_numpy: missing arrays {missing}")
    fields = {}
    for name, shape in shapes.items():
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(
                f"tables_from_numpy: {name} has shape {a.shape}, "
                f"expected {shape} for k={spec.k}, rho={rho}"
            )
        fields[name] = np.array(a, dtype=_TABLE_DTYPES[name])
    tables = AcsTables(spec=spec, rho=rho, **fields)
    if "fused_w" in arrays and not np.array_equal(
        np.asarray(arrays["fused_w"], np.float32), tables.fused_w
    ):
        raise ValueError(
            "tables_from_numpy: fused_w is not [theta_t ; pred_onehot]"
        )
    return tables
