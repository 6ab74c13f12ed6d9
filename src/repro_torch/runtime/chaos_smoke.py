"""Chaos smoke gate, a port of the reference's ``runtime/chaos_smoke.py``.

    PYTHONPATH=src python -m repro_torch.runtime.chaos_smoke [--device cpu]

A seeded kill schedule (3 device failures, 2 timeouts, 1 straggler, 1
transient compile error) is driven through a DecodeEngine serving
chunked-streaming sessions plus batch traffic, followed by a
checkpoint/failover handoff to a second engine, on the card unless
``--device cpu``.  The gate asserts end to end:

  * zero dropped sessions — every session survives the schedule (faulted
    session dispatches defer, they never lose a chunk);
  * no request silently dropped — every ticket ends done-with-bits or
    done-with-a-typed-error;
  * bit-exact recovery — each session's total output (chaos run, and the
    checkpoint/replay failover) is identical to uninterrupted
    ``decode_stream_chunked``;
  * bounded retries — the engine's retry counter never exceeds the
    number of injected faults (each fault buys at most one retry).

A second stage injects the silent fault kind: >= 2
``bit_flip`` events corrupt decoded batch output post-dispatch, and the
gate asserts the online SDC scrubber detects and quarantines every one
— corrupt bits are never emitted, the attributed device is failed over,
and clean frames stay bit-identical to an unscrubbed run.

The noise is drawn on CPU generators seeded with
``codes.simulate.point_key``, so every device decodes the same LLRs.  A
``KernelError`` is never caught here: it ends the run with a non-zero
exit, as any violation does.

Exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import functools
import sys
import tempfile
from typing import List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    import torch

    from repro_torch.codes import encode_standard, get_code, standard_llrs
    from repro_torch.codes.simulate import point_key
    from repro_torch.core.decoder import ViterbiDecoder
    from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule, FaultEvent
    from repro_torch.serve.engine import DecodeEngine as _Engine
    from repro_torch.serve.engine import DecodeRequest

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.runtime.chaos_smoke",
        description="chaos smoke gate",
    )
    ap.add_argument("--device", default=None,
                    help="the engines' device: cpu, or the card (default)")
    args = ap.parse_args(argv)
    DecodeEngine = functools.partial(_Engine, device=args.device)

    code = get_code("ccsds-k7")
    T, C, DEPTH = 1024, 256, 256

    def stream(seed):
        bits = torch.as_tensor(
            np.random.default_rng(seed).integers(0, 2, (1, T)), dtype=torch.int32
        )
        gen = torch.Generator().manual_seed(point_key(seed, code.name, 4.0))
        return standard_llrs(
            gen, encode_standard(bits, code), 4.0, code
        ).numpy()[0]

    streams = {f"t{i}": stream(i) for i in range(2)}
    dec = ViterbiDecoder.from_standard(
        "ccsds-k7", decision_depth=DEPTH, device=args.device)
    refs = {
        sid: dec.decode_stream_chunked(
            s[None], chunk_len=C, initial_state=None
        ).cpu().numpy()[0]
        for sid, s in streams.items()
    }

    # the seeded kill schedule: >=3 device failures + >=2 timeouts
    # landing on session dispatches, plus a straggler and a compile flake
    schedule = ChaosSchedule(
        [FaultEvent(at=a, kind="device_failure") for a in (0, 3, 6)]
        + [FaultEvent(at=a, kind="timeout") for a in (1, 8)]
        + [FaultEvent(at=4, kind="slow", delay=0.01),
           FaultEvent(at=10, kind="compile_error")]
    )
    injector = ChaosInjector(schedule)
    engine = DecodeEngine(
        max_batch=4, decision_depth=DEPTH, chaos=injector,
        dispatch_timeout=0.1,
    )
    for sid in streams:
        engine.open_session("ccsds-k7", sid=sid, now=0.0)
    tickets = {sid: [] for sid in streams}
    batch_tickets = []
    for i in range(T // C):
        now = float(i)
        for sid, s in sorted(streams.items()):
            tickets[sid].append(
                engine.submit_chunk(sid, s[i * C:(i + 1) * C], now=now)
            )
        # concurrent stateless batch traffic rides the same schedule
        batch_tickets.append(engine.submit(
            DecodeRequest(streams["t0"][: 3 * 32]), now=now
        ))
        engine.poll(now=now)
    engine.drain(now=10.0)

    # zero dropped sessions; every ticket resolved (bits or typed error)
    assert len(engine.stats()["faults"]) > 0, "schedule never fired"
    for sid in streams:
        assert sid not in engine._evicted, f"session {sid} dropped"
    all_t = [t for ts in tickets.values() for t in ts] + batch_tickets
    unresolved = [t.id for t in all_t if not (t.done or t.dropped)]
    assert not unresolved, f"silently dropped tickets: {unresolved}"
    assert all(t.error is None for t in all_t), (
        [t.error for t in all_t if t.error]
    )

    # bit-exact session output under chaos
    for sid in sorted(streams):
        tail = engine.close_session(sid, now=10.0)
        got = np.concatenate([t.bits for t in tickets[sid]] + [tail])
        assert np.array_equal(got, refs[sid]), f"{sid}: not bit-exact"

    # bounded retries: each injected fault buys at most one retry
    s = engine.stats()
    injected = injector.total_injected()
    assert s["retries"] <= injected, (s["retries"], injected)

    # checkpoint -> crash -> restore -> replay window: bit-exact
    with tempfile.TemporaryDirectory() as d:
        a = DecodeEngine(max_batch=4, decision_depth=DEPTH,
                         checkpoint_dir=d)
        a.open_session("ccsds-k7", sid="t0", now=0.0)
        s0 = streams["t0"]
        pre = []
        for i in range(2):
            t = a.submit_chunk("t0", s0[i * C:(i + 1) * C], now=float(i))
            a.poll(now=float(i))
            pre.append(t.bits)
        a.checkpoint_sessions(now=2.0)
        t = a.submit_chunk("t0", s0[2 * C:3 * C], now=2.5)  # post-ckpt
        a.poll(now=2.5)
        lost = t.bits  # emitted by the engine that "dies" here

        b = DecodeEngine(max_batch=4, decision_depth=DEPTH,
                         checkpoint_dir=d)
        resume = b.restore_sessions(now=3.0)
        assert resume == {"t0": 2 * C}, resume
        tr = b.submit_chunk("t0", s0[2 * C:3 * C], now=3.0)  # replay
        b.poll(now=3.0)
        assert np.array_equal(tr.bits, lost), "replay not idempotent"
        t3 = b.submit_chunk("t0", s0[3 * C:4 * C], now=4.0)
        b.poll(now=4.0)
        tail = b.close_session("t0", now=5.0)
        got = np.concatenate(pre + [tr.bits, t3.bits, tail])
        assert np.array_equal(got, refs["t0"]), "failover not bit-exact"

    # -- stage 2: silent data corruption ----------------------------------
    # >= 2 bit_flip events against scrubbed batch traffic: every
    # corrupted frame must end sdc_detected (never emitted), the
    # attributed device quarantined, clean frames bit-identical
    from repro_torch.codes.simulate import sim_frame_batch

    _, frame_llrs = sim_frame_batch(
        torch.Generator().manual_seed(point_key(7, code.name, 6.5)),
        code, 8, 120, 6.5,
    )
    frame_llrs = frame_llrs.numpy()

    def sdc_run(chaos=None, scrub=1.0):
        eng = DecodeEngine(max_batch=4, scrub=scrub, chaos=chaos)
        ts = [eng.submit(DecodeRequest(
            llrs=frame_llrs[i], code="ccsds-k7", flushed=True
        ), now=0.0) for i in range(8)]
        eng.drain(now=0.0)
        return eng, ts

    _, ref_t = sdc_run(scrub=0.0)
    ref_bits = [t.bits.copy() for t in ref_t]
    sdc_sched = ChaosSchedule([
        FaultEvent(at=0, kind="bit_flip", device=0, flips=2),
        FaultEvent(at=1, kind="bit_flip", device=0, flips=2),
    ])
    sdc_inj = ChaosInjector(sdc_sched)
    eng2, t2 = sdc_run(chaos=sdc_inj)
    s2 = eng2.stats()
    assert sdc_inj.injected["bit_flip"] == 2, sdc_inj.injected
    detected = [i for i, t in enumerate(t2) if t.error == "sdc_detected"]
    missed = [
        i for i, t in enumerate(t2)
        if t.error is None and not np.array_equal(t.bits, ref_bits[i])
    ]
    assert not missed, f"corrupt bits emitted undetected: {missed}"
    assert len(detected) >= 2, f"SDCs detected: {detected}"
    assert s2["scrub"]["confirmed"] == len(detected), s2["scrub"]
    assert s2["scrub"]["false_alarms"] == 0, s2["scrub"]
    assert s2["quarantined"] == [0], s2["quarantined"]
    assert s2["failovers"] >= 1, s2["failovers"]
    for i, t in enumerate(t2):
        if i not in detected:
            assert np.array_equal(t.bits, ref_bits[i]), i

    print(
        f"[chaos-smoke] PASS: {len(streams)} sessions bit-exact under "
        f"{injected} injected faults ({dict(injector.injected)}); "
        f"retries={s['retries']} (bound {injected}); "
        f"failovers={s['failovers']}; checkpoint/replay failover "
        f"bit-exact; 0 dropped; {len(detected)} injected SDCs "
        f"detected+quarantined (0 false positives)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
