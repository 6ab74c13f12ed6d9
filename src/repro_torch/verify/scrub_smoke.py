"""SDC-scrubber smoke gate, a port of the reference's
``verify/scrub_smoke.py``.

    PYTHONPATH=src python -m repro_torch.verify.scrub_smoke [--device cpu]

A mesh of two shards (``frame_mesh(2, device=...)``: two logical shards
on the card unless ``--device cpu``) serves two waves of batch traffic
through the DecodeEngine with the online scrubber at rate 1.0, under a
deterministic ``bit_flip`` chaos schedule that silently corrupts
decoded bits after the dispatch.  The gate asserts:

  * 100% detection — every frame the schedule corrupted ends with a
    typed ``sdc_detected`` ticket error (corrupt bits are never
    emitted as results);
  * zero false positives — no clean frame is flagged, and every clean
    frame's bits are bit-identical to an unscrubbed reference run;
  * quarantine -> failover — the confirmed corruption's attributed
    shard leaves the mesh through ``replan_mesh`` (failovers >= 1) and
    the engine keeps serving on the survivor;
  * rate-0 inertness — with ``scrub=0.0`` the engine makes no scrub
    calls at all and its output is bit-identical to the scrubbed
    engine's clean frames.

The noise is drawn on CPU generators seeded with
``codes.simulate.point_key``.  Exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    import numpy as np
    import torch

    from repro_torch.codes.registry import get_code
    from repro_torch.codes.simulate import point_key, sim_frame_batch
    from repro_torch.distributed.decoder import frame_mesh
    from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule, FaultEvent
    from repro_torch.serve.engine import DecodeEngine, DecodeRequest

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify.scrub_smoke",
        description="SDC-scrubber smoke gate",
    )
    ap.add_argument("--device", default=None,
                    help="the engines' device: cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = args.device

    code = get_code("ccsds-k7")
    F, N_BITS, EBN0 = 8, 120, 6.5
    waves = []
    for w in range(2):
        _, llrs = sim_frame_batch(
            torch.Generator().manual_seed(point_key(w, code.name, EBN0)),
            code, F, N_BITS, EBN0,
        )
        waves.append(llrs.numpy())

    def run(chaos=None, scrub=1.0, mesh=None):
        eng = DecodeEngine(
            max_batch=F, scrub=scrub, chaos=chaos, mesh=mesh, device=dev,
        )
        tickets = []
        for w, llrs in enumerate(waves):
            tickets.append([
                eng.submit(DecodeRequest(
                    llrs=llrs[i], code="ccsds-k7", flushed=True
                ), now=float(w))
                for i in range(F)
            ])
            eng.poll(now=float(w) + 1.0)
        eng.drain(now=10.0)
        return eng, tickets

    # unscrubbed clean reference: the ground-truth bits per frame
    ref_eng, ref = run(scrub=0.0)
    assert all(t.error is None for ts in ref for t in ts)
    ref_bits = [[t.bits.copy() for t in ts] for ts in ref]

    # scrubbed clean run: zero flags, bit-identical to the reference
    # (rate-0 inertness read the other way around)
    clean_eng, clean = run(scrub=1.0)
    s = clean_eng.stats()
    assert s["scrub"]["syndrome_flags"] == 0, s["scrub"]
    assert s["scrub"]["frames"] == 2 * F, s["scrub"]
    for ts, rb in zip(clean, ref_bits):
        for t, r in zip(ts, rb):
            assert t.error is None and np.array_equal(t.bits, r)

    # chaos run on the 2-shard mesh: one bit_flip event per wave, both
    # attributed to shard 0, silently corrupting decoded bits
    schedule = ChaosSchedule([
        FaultEvent(at=0, kind="bit_flip", device=0, flips=3),
        FaultEvent(at=1, kind="bit_flip", device=0, flips=3),
    ])
    injector = ChaosInjector(schedule)
    eng, tickets = run(chaos=injector, scrub=1.0, mesh=frame_mesh(2, device=dev or "cuda"))
    s = eng.stats()

    # which frames did the schedule actually corrupt?  (re-derive from
    # the seeded flip positions against the clean reference)
    detected, corrupted, false_pos = set(), set(), []
    for w, ts in enumerate(tickets):
        for i, t in enumerate(ts):
            if t.error == "sdc_detected":
                detected.add((w, i))
            elif not np.array_equal(t.bits, ref_bits[w][i]):
                corrupted.add((w, i))  # corrupt bits EMITTED: a miss
            # a clean frame flagged would have error set
    # every corrupted frame was caught before emission
    assert not corrupted, f"corrupt bits emitted undetected: {corrupted}"
    assert injector.injected["bit_flip"] == 2, injector.injected
    assert detected, "schedule fired but nothing was detected"
    assert s["scrub"]["confirmed"] == len(detected), s["scrub"]
    # zero false positives: flags == confirmed (shadow cleared none),
    # and every clean frame matches the reference bit-for-bit
    assert s["scrub"]["false_alarms"] == 0, s["scrub"]
    for w, ts in enumerate(tickets):
        for i, t in enumerate(ts):
            if (w, i) not in detected:
                assert t.error is None
                assert np.array_equal(t.bits, ref_bits[w][i]), (w, i)
    false_pos = [
        (w, i) for w, ts in enumerate(tickets)
        for i, t in enumerate(ts)
        if t.error == "sdc_detected"
        and (w, i) not in detected
    ]
    assert not false_pos

    # quarantine -> failover: shard 0 left the mesh, the plan shrank
    # onto the survivor, and the engine kept serving
    assert s["quarantined"] == [0], s["quarantined"]
    assert s["failovers"] >= 1, s["failovers"]
    assert eng.mesh is not None and eng.mesh.size == 1

    print(
        f"[sdc-smoke] PASS: {len(detected)} corrupted frames across "
        f"{injector.injected['bit_flip']} injected bit_flip events all "
        f"detected+confirmed ({s['scrub']['frames']} frames scrubbed, "
        f"0 false positives); device 0 quarantined "
        f"(failovers={s['failovers']}, mesh 2 -> "
        f"{eng.mesh.size}); rate-0 run bit-identical"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
