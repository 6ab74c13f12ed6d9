"""Convolutional encoder (paper §II-A, Fig. 1a).

  * ``conv_encode`` — numpy, one bit at a time through the FSM tables
    (the test oracle, as in the reference);
  * ``conv_encode_torch`` — the same code on a batch of bit rows in
    PyTorch, on any device: each output bit is the XOR of the input taps
    its generator polynomial selects, so the whole batch encodes in k
    shifted XORs instead of a loop over stages.  It stands where the
    reference has ``conv_encode_jax`` and makes full-width test data.

Both take ``tail_bite=True`` for tail-biting frames: the register starts
from the frame's last k-1 bits (``tail_bite_state``), so the encoder ends
where it started and no tail is sent (LTE TBCC termination).
"""
from __future__ import annotations

import numpy as np
import torch

from .trellis import CodeSpec, build_transitions

__all__ = ["conv_encode", "conv_encode_torch", "tail_flush", "tail_bite_state"]


def tail_flush(bits: np.ndarray, spec: CodeSpec) -> np.ndarray:
    """Append k-1 zero bits so the encoder FSM terminates in state 0."""
    return np.concatenate([np.asarray(bits), np.zeros(spec.k - 1, dtype=np.int64)])


def tail_bite_state(bits, k: int) -> int:
    """Tail-biting boundary state: the last k-1 message bits, most recent
    at the MSB (trellis.py state convention).  The encoder starts AND
    ends here; the WAVA consistency probe (codes/tailbiting.py) tests
    against the same value."""
    bits = np.asarray(bits)
    if bits.shape[0] < k - 1:
        raise ValueError(
            f"tail-biting needs >= k-1={k - 1} bits, got {bits.shape[0]}"
        )
    s = 0
    for i in range(k - 1):
        s |= int(bits[-1 - i]) << (k - 2 - i)
    return s


def conv_encode(
    bits, spec: CodeSpec, initial_state: int = 0, tail_bite: bool = False
) -> np.ndarray:
    """Encode a bit vector.  Returns (n, beta) array of 0/1 output bits.
    ``tail_bite=True`` starts the register from the last k-1 bits."""
    tr = build_transitions(spec)
    bits = np.asarray(bits, dtype=np.int64)
    s = tail_bite_state(bits, spec.k) if tail_bite else initial_state
    out = np.zeros((bits.shape[0], spec.beta), dtype=np.int64)
    for t, u in enumerate(bits):
        out[t] = tr.out_bits[s, u]
        s = int(tr.next_state[s, u])
    return out


def conv_encode_torch(
    bits: torch.Tensor,
    spec: CodeSpec,
    initial_state: int = 0,
    tail_bite: bool = False,
) -> torch.Tensor:
    """bits (..., n) 0/1 integers -> (..., n, beta) uint8 coded bits.

    The register at stage t is (u_t, u_{t-1}, ..., u_{t-k+1}) from the
    MSB down (trellis.py), so output b is the XOR over taps i of
    u_{t-i} wherever bit (k-1-i) of poly_b is set; the k-1 bits before
    the first stage come from ``initial_state``, or with ``tail_bite``
    from each row's own last k-1 bits (u_{-i} = u_{n-i})."""
    k = spec.k
    bits = torch.as_tensor(bits).to(torch.uint8)
    n = bits.shape[-1]
    if tail_bite:
        if n < k - 1:
            raise ValueError(f"tail-biting needs >= k-1={k - 1} bits, got {n}")
        pre = bits[..., n - (k - 1):]
    else:
        pre = torch.tensor(
            [(initial_state >> (k - 1 - i)) & 1 for i in range(k - 1, 0, -1)],
            dtype=torch.uint8, device=bits.device,
        ).expand(*bits.shape[:-1], k - 1)
    reg = torch.cat([pre, bits], dim=-1)  # reg[..., k-1+t] = u_t
    outs = []
    for g in spec.polys:
        acc = torch.zeros_like(bits)
        for i in range(k):
            if (g >> (k - 1 - i)) & 1:
                acc ^= reg[..., k - 1 - i : k - 1 - i + n]
        outs.append(acc)
    return torch.stack(outs, dim=-1)
