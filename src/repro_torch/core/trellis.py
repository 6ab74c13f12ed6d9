"""Convolutional-code trellis structure (paper §II, §IV, §VII), in numpy.

Conventions (paper Fig. 1, Eq. 1), the same as the reference's:
  * state s at time t = previous k-1 input bits, most recent at the MSB;
  * transition on input bit u:  next = (u << (k-2)) | (s >> 1);
  * output bit b = parity( ((u << (k-1)) | s) & poly_b ).

The fused ACS tables below are the decoder's only "parameters": the
stacked operand W = [theta_t ; pred_onehot] of the per-step matmul.
``tables_from_numpy`` rebuilds them from arrays made elsewhere (for
example by the JAX reference), so the two packages can be held to the
same tables; ``reverse_tables_from_numpy`` does the same for the
time-reversed tables of the BCJR beta recursion (``ReverseTables``).
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
    "ReverseTables",
    "build_transitions",
    "build_acs_tables",
    "build_reverse_tables",
    "superbranch_output_bits",
    "tables_from_numpy",
    "reverse_tables_from_numpy",
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


@dataclasses.dataclass(frozen=True, eq=False)  # arrays: compare by identity
class ReverseTables:
    """Tables for the time-reversed fused step (the BCJR beta recursion).

        beta_t[i] = lse_v ( branch(i, v) + beta_{t+1}[succ(i, v)] )

    is the forward step's matmul shape with predecessor and successor
    swapped: column (i*R + v) of theta_rev holds the +-1 output pattern
    of the super-branch leaving state i on the rho input bits of v
    (chronological, LSB-first), and succ_onehot routes beta_{t+1} from
    succ(i, v) = (v << (k-1-rho)) | (i >> rho).
    """

    spec: CodeSpec
    rho: int
    theta_rev: np.ndarray  # (rho*beta, S*R) float32, +-1
    succ_onehot: np.ndarray  # (S, S*R) float32, one-hot
    succ_state: np.ndarray  # (S, R) int32

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
        """The stacked (B+S, S*R) operand of the reversed fused matmul."""
        return np.concatenate([self.theta_rev, self.succ_onehot], axis=0)


@functools.lru_cache(maxsize=64)
def build_reverse_tables(spec: CodeSpec, rho: int = 2) -> ReverseTables:
    _check_rho(spec, rho)
    S = spec.n_states
    R = 1 << rho
    B = rho * spec.beta

    theta_rev = np.zeros((B, S * R), dtype=np.float32)
    succ_onehot = np.zeros((S, S * R), dtype=np.float32)
    succ_state = np.zeros((S, R), dtype=np.int32)

    tr = build_transitions(spec)
    for i in range(S):
        for v in range(R):
            in_bits = [(v >> b) & 1 for b in range(rho)]  # chronological
            s = i
            for u in in_bits:
                s = int(tr.next_state[s, u])
            col = i * R + v
            succ_state[i, v] = s
            bits = superbranch_output_bits(spec, i, in_bits)
            theta_rev[:, col] = [(-1.0) ** b for b in bits]
            succ_onehot[s, col] = 1.0

    return ReverseTables(
        spec=spec,
        rho=rho,
        theta_rev=theta_rev,
        succ_onehot=succ_onehot,
        succ_state=succ_state,
    )


_TABLE_DTYPES = {
    "theta_t": np.float32,
    "pred_onehot": np.float32,
    "pred_state": np.int32,
    "dec_bits": np.int32,
    "theta_rev": np.float32,
    "succ_onehot": np.float32,
    "succ_state": np.int32,
}


def _carry_arrays(who, spec, rho, arrays, shapes):
    """The named arrays, shape-checked against (spec, rho) and cast to
    the tables' dtypes."""
    missing = sorted(set(shapes) - set(arrays))
    if missing:
        raise ValueError(f"{who}: missing arrays {missing}")
    fields = {}
    for name, shape in shapes.items():
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(
                f"{who}: {name} has shape {a.shape}, "
                f"expected {shape} for k={spec.k}, rho={rho}"
            )
        fields[name] = np.array(a, dtype=_TABLE_DTYPES[name])
    return fields


def _check_fused_w(who, arrays, tables):
    if "fused_w" in arrays and not np.array_equal(
        np.asarray(arrays["fused_w"], np.float32), tables.fused_w
    ):
        raise ValueError(f"{who}: fused_w is not the stack of its halves")


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
    who = "tables_from_numpy"
    tables = AcsTables(
        spec=spec, rho=rho, **_carry_arrays(who, spec, rho, arrays, shapes)
    )
    _check_fused_w(who, arrays, tables)
    return tables


def reverse_tables_from_numpy(
    spec: CodeSpec, rho: int, arrays: Dict[str, np.ndarray]
) -> ReverseTables:
    """``tables_from_numpy`` for ``ReverseTables``: ``arrays`` holds
    ``theta_rev``, ``succ_onehot`` and ``succ_state``, and may hold
    ``fused_w``, which must then equal their stack."""
    _check_rho(spec, rho)
    S, R, B = spec.n_states, 1 << rho, rho * spec.beta
    shapes = {
        "theta_rev": (B, S * R),
        "succ_onehot": (S, S * R),
        "succ_state": (S, R),
    }
    who = "reverse_tables_from_numpy"
    tables = ReverseTables(
        spec=spec, rho=rho, **_carry_arrays(who, spec, rho, arrays, shapes)
    )
    _check_fused_w(who, arrays, tables)
    return tables
