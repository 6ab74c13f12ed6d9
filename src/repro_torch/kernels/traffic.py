"""Device-memory bytes accessed by the streaming decode paths, the port of
the reference's ``kernels/traffic.py``.

Checks the DESIGN.md §8 traffic claim statically: the one-pass decode
(K2, ``acs_decode_fused``) must beat the two-pass path (K1 writes the
survivors phi to device memory, then the traceback reads them back) by a
wide margin, because the survivor tensor (S int8s per frame per step, an
order of magnitude more than the LLRs) never leaves the chip.

Accounting model, the reference's static one number for number:

  * a kernel's traffic is its interface: every operand read once and
    every result written once, charged from the shapes and dtypes;
  * the stages around it (the two-pass traceback, the flush, the bit
    repack) are charged by the same materialise-at-the-boundary model
    (concat and traceback read the survivor tensor once, bits come out
    once).

The reference can also lower its XLA stages and count their bytes in the
HLO (``xla="hlo"``, its default on a TPU).  That lowering has no torch
form: here ``"static"`` and ``"auto"`` both mean the model above, and
``"hlo"`` raises.

On the H100 the model's premise holds for K2 at the acceptance shape
(T = 512 stages, F = 1024 frames, K = 7, rho = 2, decision depth 128
stages, packed ring): ``k2_ring_in_smem`` asks
``kernel_geometry.k2_block_frames``, which puts each block's rings and
per-tile maps in shared memory beside its staging (four frames a block,
``k2_smem_bytes``), so no survivor of that shape touches device memory
between the entry and the exit ring.  At depths whose rings do not fit,
K2 keeps them in a scratch buffer in device memory instead, and the
model undercounts K2's bytes.

Run as a module for the report the parity gate reads:

    PYTHONPATH=src python -m repro_torch.kernels.traffic
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.kernel_geometry import (
    k2_block_frames,
    pick_time_tile,
    ring_dtype,
    ring_words,
)
from repro_torch.core.trellis import CODE_K7_CCSDS, CodeSpec, build_acs_tables
from repro_torch.core.viterbi import AcsPrecision

__all__ = [
    "StreamTraffic",
    "two_pass_stream_traffic",
    "one_pass_stream_traffic",
    "k2_ring_in_smem",
    "streaming_traffic_report",
]


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _resolve_xla_mode(xla: str) -> str:
    """``"auto"`` and ``"static"`` are the static boundary model;
    ``"hlo"``, the reference's measured lowering, has no torch form."""
    if xla == "hlo":
        raise ValueError(
            "xla='hlo' counts the bytes of an XLA lowering (hlocount), "
            "which the port does not have; use 'static' or 'auto'"
        )
    if xla not in ("auto", "static"):
        raise ValueError(f"xla mode must be auto|hlo|static, got {xla!r}")
    return "static"


@dataclasses.dataclass(frozen=True)
class StreamTraffic:
    """Device-memory bytes accessed by one streaming-decode configuration."""

    label: str
    kernel_bytes: int  # the kernel's interface: operands + results
    xla_bytes: float  # the stages around it (the reference's name)
    breakdown: dict

    @property
    def total(self) -> float:
        return self.kernel_bytes + self.xla_bytes

    def row(self) -> dict:
        return {
            "label": self.label,
            "kernel_bytes": int(self.kernel_bytes),
            "xla_bytes": int(self.xla_bytes),
            "total_bytes": int(self.total),
            "breakdown": {k: int(v) for k, v in self.breakdown.items()},
        }


def _static_flush_bytes(D, F, W_bytes, rho) -> int:
    """Boundary model of the flush traceback: read the ring once, emit
    the tail bits once."""
    return D * F * W_bytes + F * D * rho * 4


def _static_two_pass_post_bytes(T, D, F, W_bytes, rho) -> int:
    """Boundary model of the two-pass chunk tail (``_chunk_step`` after
    the forward kernel): concat ring+phi (read both, write full), scan
    the full survivor tensor back (read), emit all bits, slice out the
    new ring tail and the chunk's bit window (2x result each)."""
    full = (T + D) * F * W_bytes
    return int(
        full                      # read phis + hist into the concat
        + full                    # write the concatenated tensor
        + full                    # traceback reads it all back
        + F * (T + D) * rho * 4   # bits over every step, int32
        + 2 * D * F * W_bytes     # ring-tail slice out
        + 2 * F * T * rho * 4     # chunk bit-window slice out
    )


def _static_one_pass_post_bytes(T, F, rho) -> int:
    """Boundary model of the one-pass chunk tail: the (T*rho, F) int8
    decision plane is transposed and widened to the (F, T*rho) int32
    contract, read once and written once."""
    return T * rho * F * 1 + T * rho * F * 4


def two_pass_stream_traffic(
    n_stages: int = 512,
    n_frames: int = 1024,
    spec: CodeSpec = CODE_K7_CCSDS,
    rho: int = 2,
    decision_depth: int = 128,
    pack_survivors: bool = False,
    precision: Optional[AcsPrecision] = None,
    xla: str = "auto",
) -> StreamTraffic:
    """Streaming decode via the two-pass path: K1 writes phi (T, F, S)
    to device memory, then the chunk step concatenates it onto the ring
    and scans it all back (one chunk + flush, the
    ``decode_stream_chunked`` shape)."""
    _resolve_xla_mode(xla)
    precision = precision or AcsPrecision()
    tables = build_acs_tables(spec, rho)
    T, F = n_stages // rho, n_frames
    D = decision_depth // rho
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    W = ring_words(S, pack_survivors)
    phi_dt = ring_dtype(pack_survivors)
    mm = precision.matmul_dtype.itemsize

    kb = {
        "blocks_in": T * F * B * mm,
        "lam0_in": _nbytes((F, S), torch.float32),
        "w_in": (B + S) * S * R * mm,
        "lam_out": _nbytes((F, S), torch.float32),
        "phi_out": _nbytes((T, F, W), phi_dt),
    }
    W_bytes = W * phi_dt.itemsize
    xb = {
        "chunk_post": _static_two_pass_post_bytes(T, D, F, W_bytes, rho),
        "flush": _static_flush_bytes(D, F, W_bytes, rho),
    }
    return StreamTraffic(
        label=f"two-pass/pack={pack_survivors}",
        kernel_bytes=sum(kb.values()),
        xla_bytes=sum(xb.values()),
        breakdown={**kb, **xb},
    )


def one_pass_stream_traffic(
    n_stages: int = 512,
    n_frames: int = 1024,
    spec: CodeSpec = CODE_K7_CCSDS,
    rho: int = 2,
    decision_depth: int = 128,
    pack_survivors: bool = True,
    time_tile: Optional[int] = None,
    precision: Optional[AcsPrecision] = None,
    xla: str = "auto",
) -> StreamTraffic:
    """Streaming decode via the one-pass kernel K2 (DESIGN.md §8): phi
    lives in K2's ring on the chip; device memory sees the LLR blocks,
    the decision bits, and the bounded (decision-depth) entry and exit
    rings."""
    _resolve_xla_mode(xla)
    precision = precision or AcsPrecision()
    tables = build_acs_tables(spec, rho)
    T, F = n_stages // rho, n_frames
    D = decision_depth // rho
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    W = ring_words(S, pack_survivors)
    ring_dt = ring_dtype(pack_survivors)
    mm = precision.matmul_dtype.itemsize
    tt = pick_time_tile(D, T, time_tile)

    kb = {
        "blocks_in": T * F * B * mm,
        "lam0_in": _nbytes((F, S), torch.float32),
        "hist_in": _nbytes((D, F, W), ring_dt),
        "w_in": (B + S) * S * R * mm,
        "bits_out": _nbytes((T * rho, F), torch.int8),
        "lam_out": _nbytes((F, S), torch.float32),
        "hist_out": _nbytes((D, F, W), ring_dt),
    }
    W_bytes = W * ring_dt.itemsize
    xb = {
        "chunk_post": _static_one_pass_post_bytes(T, F, rho),
        "flush": _static_flush_bytes(D, F, W_bytes, rho),
    }
    return StreamTraffic(
        label=f"one-pass/pack={pack_survivors}/tile={tt}",
        kernel_bytes=sum(kb.values()),
        xla_bytes=sum(xb.values()),
        breakdown={**kb, **xb},
    )


def k2_ring_in_smem(
    n_stages: int = 512,
    n_frames: int = 1024,
    spec: CodeSpec = CODE_K7_CCSDS,
    rho: int = 2,
    decision_depth: int = 128,
    pack_survivors: bool = True,
    time_tile: Optional[int] = None,
) -> bool:
    """Whether K2 keeps its rings in shared memory at this shape on an
    H100 (``kernel_geometry.k2_block_frames``): the premise of the
    one-pass model, that survivors never reach device memory."""
    tables = build_acs_tables(spec, rho)
    T, D = n_stages // rho, decision_depth // rho
    n_cols = len(np.unique(tables.theta_t.T, axis=0))
    _, in_smem = k2_block_frames(
        tables.n_states, tables.llr_block, n_cols, D,
        pick_time_tile(D, T, time_tile), pack_survivors, n_frames,
    )
    return in_smem


@functools.lru_cache(maxsize=8)
def streaming_traffic_report(
    n_stages: int = 512,
    n_frames: int = 1024,
    decision_depth: int = 128,
    xla: str = "auto",
) -> dict:
    """Side-by-side bytes-accessed report at the acceptance shape
    (T=512 stages, F=1024, K=7, rho=2 by default): the two-pass default
    (unpacked phi), the packed two-pass, and the one-pass kernel;
    ``ratio`` is default two-pass over one-pass.  ``xla_mode`` is always
    ``"static"``; ``k2_ring_in_smem`` says whether the one-pass premise
    holds for K2 at this shape."""
    mode = _resolve_xla_mode(xla)
    two = two_pass_stream_traffic(
        n_stages, n_frames, decision_depth=decision_depth,
        pack_survivors=False, xla=mode,
    )
    two_packed = two_pass_stream_traffic(
        n_stages, n_frames, decision_depth=decision_depth,
        pack_survivors=True, xla=mode,
    )
    one = one_pass_stream_traffic(
        n_stages, n_frames, decision_depth=decision_depth,
        pack_survivors=True, xla=mode,
    )
    return {
        "shape": {
            "n_stages": n_stages,
            "n_frames": n_frames,
            "decision_depth": decision_depth,
            "spec": "k7-ccsds",
            "rho": 2,
        },
        "xla_mode": mode,
        "two_pass": two.row(),
        "two_pass_packed": two_packed.row(),
        "one_pass": one.row(),
        "ratio": two.total / one.total,
        "ratio_vs_packed": two_packed.total / one.total,
        "k2_ring_in_smem": k2_ring_in_smem(
            n_stages, n_frames, decision_depth=decision_depth,
        ),
    }


def main() -> None:
    import json

    rep = streaming_traffic_report()
    print(json.dumps(rep, indent=2))


if __name__ == "__main__":
    main()
