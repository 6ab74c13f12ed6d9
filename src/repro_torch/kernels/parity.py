"""Kernel-parity gate, the port of the reference's ``kernels/parity.py``:
the one-pass kernel K2 (DESIGN.md §8) on a punctured wifi-11a stream,
the time-parallel transfer-matrix path with K3 (DESIGN.md §9), and the
static traffic check.

    PYTHONPATH=src python -m repro_torch.kernels.parity [--device cpu]

On the card (the default) every kernel call launches its CUDA kernel;
with ``--device cpu`` the wrappers run their plain versions.  Asserts:

  1. chunked streaming of a punctured ``wifi-11a-r34`` LLR stream through
     K2 (one-pass, packed ring, erasure LLRs through the unchanged step)
     is bit-identical to BOTH the plain two-pass chunked path
     (``use_kernel=False``) and the whole-frame sequential decode, and
     recovers the message at 6 dB;
  2. K2 replays ``decoder._chunk_step`` tile by tile: same committed
     bits, same exit metrics, same exit ring, packed and unpacked;
  3. the streaming path's device-memory bytes (``kernels.traffic``'s
     static interface model) drop >= 5x against the two-pass path at the
     acceptance shape T=512 stages, F=1024, K=7, rho=2, and K2 keeps its
     rings in shared memory there (the model's premise);
  4. the time-parallel decode of a punctured wifi-11a stream (transfer
     matrices formed by K3, scanned, survivors recovered by K1) is
     bit-identical to the sequential decode, and K3's formation equals
     the plain formation exactly.

The reference also lowers both decodes and asserts with ``hlocount``
that the HLO's longest loop shrinks from T' steps to one transfer tile.
That lowering has no torch form.  In its place check 4 asserts the plan
and the calls: ``time_parallel_plan`` picks the 32-step tile, and the
decode makes one K3 call and one K1 call, the recovery, whose blocks
run one tile of steps (on the card, one launch each).

The noise of checks 1 and 4 is drawn from a seeded ``torch.Generator``
on the decode's device (the reference draws ``jax.random`` keys), so the
LLRs are not the reference's; each check compares the port with itself.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.core.decoder import ViterbiDecoder, _chunk_step

__all__ = [
    "check_wifi_stream", "check_state_machine", "check_traffic",
    "check_time_parallel", "main",
]


@contextlib.contextmanager
def _kernel_calls():
    """Record every call of the kernel wrappers that ``kernels.ops``
    makes, as (kernel, blocks shape); on the card also check that each
    call launched its kernel once."""
    from repro_torch.kernels import ops, viterbi_acs

    calls: List[Tuple[str, tuple]] = []
    names = {"K1": "acs_forward", "K2": "acs_decode_fused",
             "K3": "transfer_matrix"}
    saved = {k: getattr(ops, attr) for k, attr in names.items()}
    before = {k: getattr(viterbi_acs, a).launches for k, a in names.items()}

    def wrap(kernel, fn):
        def call(blocks, *args, **kw):
            calls.append((kernel, tuple(blocks.shape), blocks.device.type))
            return fn(blocks, *args, **kw)
        return call

    for k, attr in names.items():
        setattr(ops, attr, wrap(k, saved[k]))
    try:
        yield calls
    finally:
        for k, attr in names.items():
            setattr(ops, attr, saved[k])
    for k, attr in names.items():
        on_card = sum(c[0] == k and c[2] == "cuda" for c in calls)
        launched = getattr(viterbi_acs, attr).launches - before[k]
        assert launched == on_card, (
            f"{k}: {on_card} calls on the card but {launched} launches"
        )


def _wifi_llrs(name: str, n_bits: int, ebn0_db: float, seed: int,
               device: torch.device):
    """(message bits (2, n_bits), serial kept LLRs) of two frames drawn on
    ``device``."""
    from repro_torch.codes import encode_standard, standard_llrs, tx_frames
    from repro_torch.codes.registry import get_code

    code = get_code(name)
    gen = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (2, n_bits), generator=gen, device=device)
    bits = bits.to(torch.int32)
    llrs = standard_llrs(
        gen, encode_standard(tx_frames(bits, code), code), ebn0_db, code
    )
    return bits, llrs


def check_wifi_stream(n_bits: int = 1536, ebn0_db: float = 6.0,
                      device=None) -> None:
    name = "wifi-11a-r34"
    dev = resolve_device(device)
    bits, llrs = _wifi_llrs(name, n_bits, ebn0_db, 7, dev)

    full = ViterbiDecoder.from_standard(name, device=dev).decode_batch(
        llrs, time_parallel=False
    )
    one = ViterbiDecoder.from_standard(name, decision_depth=512, device=dev)
    with _kernel_calls() as calls:
        got_one = one.decode_stream_chunked(
            llrs, chunk_len=512, initial_state=None
        )
    two = ViterbiDecoder.from_standard(
        name, use_kernel=False, decision_depth=512, device=dev
    )
    got_two = two.decode_stream_chunked(
        llrs, chunk_len=512, initial_state=None
    )
    # the exact (chunk steps, depth steps) the decode above ran: the gate
    # fails loudly if those chunks ever fall back to two-pass
    assert one._one_pass_tile(512 // one.rho, one.decision_depth // one.rho), (
        "one-pass path did not engage on the decoded chunk shape"
    )
    kernels = sorted({c[0] for c in calls})
    assert kernels == ["K2"], f"the one-pass stream called {kernels}, not K2"
    assert torch.equal(got_one, full), "one-pass chunked != full decode"
    assert torch.equal(got_one, got_two), "one-pass chunked != plain chunked"
    n_err = int((got_one[:, :n_bits] != bits).sum())
    assert n_err == 0, f"{name}: {n_err} bit errors at {ebn0_db} dB"
    print(
        f"[parity] {name}: one-pass chunked ({len(calls)} K2 calls) == plain "
        f"chunked == full decode ({got_one.shape[1]} bits/frame, 0 errors "
        f"at {ebn0_db} dB) ✓"
    )


def check_state_machine(device=None) -> None:
    """K2 against ``_chunk_step`` per tile: bits, metrics and ring exact."""
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.viterbi import (
        AcsPrecision, blocks_from_llrs, init_metric,
    )
    from repro_torch.kernels.ops import ring_dtype, ring_words, viterbi_decode_fused

    dev = resolve_device(device)
    tables = build_acs_tables(CODE_K7_CCSDS, 2)
    rng = np.random.default_rng(0)
    F, n, D, TT = 3, 256, 32, 16
    llr = torch.as_tensor(rng.normal(0, 1, (F, n, 2)), dtype=torch.float32,
                          device=dev)
    blocks = blocks_from_llrs(llr, 2)
    lam0 = init_metric(F, tables.n_states, None, device=dev)
    for pack in (False, True):
        hist0 = torch.zeros((D, F, ring_words(tables, pack)),
                            dtype=ring_dtype(pack), device=dev)
        bits_k, lam_k, hist_k = viterbi_decode_fused(
            blocks, lam0, hist0, tables,
            time_tile=TT, pack_survivors=pack,
        )
        hist, lam, outs = hist0, lam0, []
        for lo in range(0, blocks.shape[0], TT):
            hist, lam, b = _chunk_step(
                hist, lam, blocks[lo:lo + TT], tables,
                AcsPrecision(), False, pack,
            )
            outs.append(b)
        assert torch.equal(bits_k.T.to(torch.int32), torch.cat(outs, dim=1)), (
            f"K2 bits != _chunk_step bits (packed={pack})"
        )
        assert torch.equal(lam_k, lam), f"K2 metrics differ (packed={pack})"
        assert torch.equal(hist_k, hist), f"K2 ring differs (packed={pack})"
    print("[parity] K2 == _chunk_step state machine (packed+unpacked) ✓")


def check_traffic(min_ratio: float = 5.0) -> None:
    from repro_torch.kernels.traffic import streaming_traffic_report

    rep = streaming_traffic_report()
    ratio = rep["ratio"]
    assert ratio >= min_ratio, (
        f"one-pass streaming accesses only {ratio:.1f}x fewer bytes "
        f"than two-pass (need >= {min_ratio}x): {rep}"
    )
    assert rep["k2_ring_in_smem"], (
        "K2 keeps its rings in device memory at the acceptance shape: the "
        "one-pass model's premise does not hold"
    )
    print(
        f"[parity] device-memory bytes at T=512,F=1024: two-pass "
        f"{rep['two_pass']['total_bytes']/1e6:.0f}MB vs one-pass "
        f"{rep['one_pass']['total_bytes']/1e6:.0f}MB "
        f"({ratio:.0f}x, packed baseline {rep['ratio_vs_packed']:.0f}x; "
        f"K2's rings in shared memory) ✓"
    )


def check_time_parallel(n_bits: int = 1018, ebn0_db: float = 6.0,
                        device=None) -> None:
    """§9 gate: K3-formed transfer matrices == the plain formation, the
    decode bit-identical to sequential, the plan's tile and the calls
    (module docstring)."""
    from repro_torch.core.backend import device_underfill_rows
    from repro_torch.core.kernel_geometry import time_parallel_plan
    from repro_torch.core.timeparallel import transfer_matrices
    from repro_torch.core.viterbi import blocks_from_llrs
    from repro_torch.kernels.ops import viterbi_transfer_matrices

    # n_bits + the k-1 tail = 1024 stages -> T' = 512 steps, so the
    # 32-step transfer tile divides evenly
    name, tile = "wifi-11a-r34", 32
    dev = resolve_device(device)
    bits, llrs = _wifi_llrs(name, n_bits, ebn0_db, 11, dev)

    seq = ViterbiDecoder.from_standard(name, device=dev)
    tp = ViterbiDecoder.from_standard(
        name, time_parallel=True, transfer_tile=tile, device=dev
    )
    got_seq = seq.decode_batch(llrs, time_parallel=False)
    with _kernel_calls() as calls:
        got_tp = tp.decode_batch(llrs)
    assert torch.equal(got_tp, got_seq), "time-parallel != sequential decode"
    n_err = int((got_tp[:, :n_bits] != bits).sum())
    assert n_err == 0, f"{name}: {n_err} bit errors at {ebn0_db} dB"

    blocks = blocks_from_llrs(seq.depunctured(llrs), 2)
    t_steps, n_frames = blocks.shape[0], blocks.shape[1]
    plan = time_parallel_plan(
        n_frames, t_steps, tp.spec.n_states, True, tile,
        device_underfill_rows(dev),
    )
    assert plan == tile, f"time_parallel_plan picked {plan}, not {tile}"
    kinds = [c[0] for c in calls]
    assert sorted(kinds) == ["K1", "K3"], (
        f"the time-parallel decode called {kinds}, not one K3 and one K1"
    )
    (k1_blocks,) = [c[1] for c in calls if c[0] == "K1"]
    assert k1_blocks[0] == tile, (
        f"the recovery ran {k1_blocks[0]} steps, not one tile of {tile}"
    )

    m_plain = transfer_matrices(
        blocks, tp.tables, tp.precision, tile, use_kernel=False
    )
    m_k3 = viterbi_transfer_matrices(blocks, tp.tables, transfer_tile=tile)
    assert torch.equal(m_k3, m_plain), "K3 formation != plain formation"
    print(
        f"[parity] {name}: time-parallel == sequential decode (K3 formation "
        f"exact; plan tile {plan}: one K3 and one K1 over {k1_blocks[0]} "
        f"steps where the sequential scan runs {t_steps}) ✓"
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to decode on (default: the card; 'cpu')")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    check_state_machine(dev)
    check_wifi_stream(device=dev)
    check_traffic()
    check_time_parallel(device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
