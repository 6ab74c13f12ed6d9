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
    "branch_output",
    "butterfly_states",
    "dragonfly_state",
    "dragonfly_theta",
    "dragonfly_output_table",
    "dragonfly_groups",
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

    @property
    def msb_lsb_one(self) -> bool:
        """Corollary 2.1 precondition: MSB and LSB of every polynomial are 1."""
        return all((g >> (self.k - 1)) & 1 and g & 1 for g in self.polys)


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


def branch_output(spec: CodeSpec, state: int, bit: int) -> int:
    """beta-bit branch output alpha_out for branch (state --bit-->), Eq. 1.

    Bit b of the result is the output of polynomial b (b=0 first).
    """
    reg = (bit << (spec.k - 1)) | state
    out = 0
    for b, g in enumerate(spec.polys):
        out |= int(bin(reg & g).count("1") & 1) << b
    return out


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


# ---------------------------------------------------------------------------
# The paper's index relations: butterflies (Theorem 1) and radix-2^rho
# dragonflies (Theorems 3-5, §VIII-D), in the paper's layout.  The decoder
# does not use them; they state the structure the fused tables encode.
# ---------------------------------------------------------------------------

def butterfly_states(spec: CodeSpec, f: int):
    """Theorem 1 / Eq. 6: global states of butterfly f.

    Returns ((i0, i1), (j0, j1)).
    """
    half = 1 << (spec.k - 2)
    if not 0 <= f < half:
        raise ValueError(f"butterfly index {f} out of range [0, {half})")
    return (2 * f, 2 * f + 1), (f, f + half)


def _bits(x: int, hi: int, lo: int) -> int:
    """Paper Eq. 23:  x_{hi:lo} = (x >> lo) & (2^(hi-lo) - 1)."""
    return (x >> lo) & ((1 << (hi - lo)) - 1)


def dragonfly_state(spec: CodeSpec, rho: int, f: int, y: int, x: int) -> int:
    """Theorem 4: global state of dragonfly f at local stage x, local state y.

    s = [pre-bubble << (k-1-x)] + [bubble << (rho-x)] + [post-bubble]
    with pre-bubble = y_{rho:rho-x}, bubble = f, post-bubble = y_{rho-x-1:0}.
    """
    k = spec.k
    if not (0 <= x <= rho and 0 <= y < (1 << rho)):
        raise ValueError("local indices out of range")
    if not 0 <= f < (1 << (k - 1 - rho)):
        raise ValueError("dragonfly index out of range")
    pre = _bits(y, rho, rho - x)
    post = _bits(y, rho - x, 0)
    return (pre << (k - 1 - x)) + (f << (rho - x)) + post


def dragonfly_theta(spec: CodeSpec, rho: int, f: int) -> np.ndarray:
    """Theta-hat_f (Eq. 36): (2^rho * 2^rho, rho*beta) matrix of +-1 entries.

    Rows are grouped in partial matrices P_j (j = local right state), each
    listing the super-branches from every local left state i into j, the
    bipartite representation of Corollary 6.1, for any rho.
    """
    S2 = 1 << rho
    rows = []
    for j_loc in range(S2):
        j_glob = dragonfly_state(spec, rho, f, j_loc, rho)
        v = j_glob >> (spec.k - 1 - rho)  # the rho input bits (u_i = bit i-1)
        in_bits = [(v >> b) & 1 for b in range(rho)]
        for i_loc in range(S2):
            i_glob = dragonfly_state(spec, rho, f, i_loc, 0)
            bits = superbranch_output_bits(spec, i_glob, in_bits)
            rows.append([(-1.0) ** b for b in bits])
    return np.asarray(rows, dtype=np.float64)  # (2^rho * 2^rho, rho*beta)


def dragonfly_output_table(spec: CodeSpec, rho: int, f: int) -> np.ndarray:
    """M[j, i] = decimal super-branch output from local-left i to local-right
    j of dragonfly f, one column of the paper's Fig. 10 (reshaped)."""
    th = dragonfly_theta(spec, rho, f)  # rows: j-major, i within (Eq. 36)
    S2 = 1 << rho
    dec = np.array(
        [int("".join("1" if v < 0 else "0" for v in row), 2) for row in th]
    )
    return dec.reshape(S2, S2)  # [j, i]


def dragonfly_groups(spec: CodeSpec, rho: int = 2):
    """§VIII-D dragonfly groups.

    Two dragonflies f, f' belong to the same group iff a SINGLE permutation
    pi of the local left states maps one output table onto the other for
    every right state simultaneously:  M_f'[j, i] = M_f[j, pi(i)], which
    lets one Theta serve the whole group after permuting the path-metric
    vectors.

    Returns (groups, tables): groups maps a canonical signature to the sorted
    dragonfly indices sharing it; tables[f] is the (2^rho, 2^rho) output
    table of dragonfly f.
    """
    import itertools

    n_df = spec.n_states >> rho
    S2 = 1 << rho
    perms = list(itertools.permutations(range(S2)))
    groups: dict = {}
    tables = []
    for f in range(n_df):
        M = dragonfly_output_table(spec, rho, f)
        tables.append(M)
        # canonical form: lexicographically smallest column permutation
        sig = min(tuple(M[:, list(p)].reshape(-1)) for p in perms)
        groups.setdefault(sig, []).append(f)
    return groups, tables


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
