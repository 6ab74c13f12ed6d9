"""The serving runtime: ``repro_torch.runtime`` (chaos schedules and
injection, failure detection, retry policy, session checkpoints) and the
engine's fault ladder against ``repro.runtime`` and the reference's
engine, on the same numpy-seeded traffic.

Chaos schedules are built in the port and loaded by the reference from
their JSON, so one file drives both engines; session checkpoints written
by either package restore in the other's engine and continue bit for
bit.  A ``KernelError`` raised inside any dispatch leaves ``poll``
untouched by the fault guards (the port's one departure from the
reference's engine).
"""
import json

import numpy as np
import pytest

from tests._torch_serving import _engines, _llrs, _replay, _same_ticket


def _both(port_cls, ref_cls, *a, **kw):
    return port_cls(*a, **kw), ref_cls(*a, **kw)


def test_failure_components_equal_the_reference():
    from repro.runtime import failure as ref

    from repro_torch.runtime import failure as ours

    mon, rmon = _both(ours.HeartbeatMonitor, ref.HeartbeatMonitor, [0, 1, 2],
                      timeout=30.0, now=100.0)
    for m in (mon, rmon):
        m.beat(1, now=125.0)
    for t in (110.0, 131.0, 156.0):
        assert mon.failed(t) == rmon.failed(t) and mon.alive(t) == rmon.alive(t)
    for axis in (1, 2, 4):
        p, rp = ours.ElasticPlanner(axis), ref.ElasticPlanner(axis)
        for alive in ([], [3], [0, 1, 2], list(range(7)), list(range(9))):
            a, b = p.plan(alive), rp.plan(alive)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.data, a.model, a.hosts, a.dropped, a.size) == (
                    b.data, b.model, b.hosts, b.dropped, b.size)
    pol, rpol = _both(ours.RetryPolicy, ref.RetryPolicy, max_retries=5,
                      backoff_base=0.05, backoff_cap=0.4)
    assert [pol.backoff(i) for i in range(8)] == [rpol.backoff(i) for i in range(8)]
    assert ours.RetryPolicy() == ours.RetryPolicy(**vars(ref.RetryPolicy()))
    sm, rsm = _both(ours.StragglerMonitor, ref.StragglerMonitor, k=1.5, patience=2)
    rng = np.random.default_rng(0)
    for _ in range(6):
        times = {h: float(rng.uniform(1, 2)) for h in range(4)}
        times[3] = 5.0
        sm.record_step(times)
        rsm.record_step(times)
    assert sm.stragglers() == rsm.stragglers() == [3]
    assert vars(ours.QuarantineRecord(1, 0.5, "c", "batch", 2)) == vars(
        ref.QuarantineRecord(1, 0.5, "c", "batch", 2))


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_generated_schedule_equals_the_reference(seed):
    from repro.runtime.chaos import ChaosSchedule as RefSchedule

    from repro_torch.runtime.chaos import ChaosSchedule

    kw = dict(seed=seed, n_attempts=400, p_device=0.03, p_timeout=0.03,
              p_slow=0.02, p_compile=0.02, n_devices=4, p_bit_flip=0.05,
              max_flips=3)
    ours, ref = ChaosSchedule.generate(**kw), RefSchedule.generate(**kw)
    assert ours.to_json() == ref.to_json() and ours.counts() == ref.counts()
    with pytest.raises(ValueError, match="sum"):
        ChaosSchedule.generate(seed=0, n_attempts=10, p_device=0.9, p_timeout=0.9)


def test_schedule_file_drives_both_packages(tmp_path):
    from repro.runtime.chaos import ChaosSchedule as RefSchedule

    from repro_torch.runtime.chaos import ChaosSchedule, FaultEvent

    sched = ChaosSchedule([
        FaultEvent(at=3, kind="device_failure", device=0),
        FaultEvent(at=1, kind="timeout", path="sharded"),
        FaultEvent(at=7, kind="slow", delay=0.25),
        FaultEvent(at=2, kind="compile_error"),
        FaultEvent(at=5, kind="bit_flip", device=1, flips=3),
    ])
    p = tmp_path / "sched.json"
    p.write_text(json.dumps(sched.to_json()))
    ref = RefSchedule.from_file(p)
    assert ref.to_json() == sched.to_json()
    back = ChaosSchedule.from_json(json.dumps(ref.to_json()))
    assert back.events == sched.events
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(at=0, kind="meteor_strike")


def test_injector_fires_and_corrupts_as_the_reference():
    from repro.runtime import chaos as ref

    from repro_torch.runtime import chaos as ours

    events = [dict(at=0, kind="timeout"), dict(at=1, kind="slow", delay=0.5),
              dict(at=2, kind="device_failure", device=3, path="sharded"),
              dict(at=3, kind="bit_flip", device=2, flips=5),
              dict(at=4, kind="compile_error")]
    injs = [m.ChaosInjector(m.ChaosSchedule.from_json({"events": events}))
            for m in (ours, ref)]
    bits = np.zeros((4, 64), np.int32)
    for path in ("batch",) * 6:
        got = []
        for inj in injs:
            try:
                got.append(("delay", inj.on_dispatch("ccsds-k7", path)))
            except Exception as e:  # noqa: BLE001 — compared by kind
                got.append(("raise", e.kind, str(e)))
        assert got[0] == got[1]
    flipped = [inj.corrupt(bits) for inj in injs]
    np.testing.assert_array_equal(flipped[0][0], flipped[1][0])
    assert flipped[0][1] == flipped[1][1] == 2 and int(flipped[0][0].sum()) == 5
    assert dict(injs[0].injected) == dict(injs[1].injected)
    assert injs[0].attempts == injs[1].attempts == 6


def test_chaos_replay_equals_the_reference(tmp_path):
    """Faults on the routes the CPU runs without kernels: compile flakes
    that degrade time_parallel to batch, a timeout and a promoted
    straggler retried on batch, a WAVA cell that exhausts its budget
    (typed errors), device failures that defer a session group to the
    next poll and a timeout there; the schedule is the port's, the
    reference reads its JSON."""
    from repro.runtime.chaos import ChaosInjector as RefInjector
    from repro.runtime.chaos import ChaosSchedule as RefSchedule
    from repro.serve.engine import DecodeRequest as RefRequest

    from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule, FaultEvent
    from repro_torch.serve import DecodeRequest

    # attempts: 0 time_parallel, then batch, wava, batch (wifi), then the
    # session groups, one a poll
    sched = ChaosSchedule(
        [FaultEvent(at=a, kind="compile_error", path="time_parallel")
         for a in (0, 1, 2)]
        + [FaultEvent(at=4, kind="timeout", path="batch"),
           FaultEvent(at=5, kind="slow", delay=0.5, path="batch")]
        + [FaultEvent(at=a, kind="timeout", path="wava") for a in (7, 8, 9)]
        + [FaultEvent(at=a, kind="device_failure", device=0, path="session")
           for a in (11, 12, 13)]
        + [FaultEvent(at=14, kind="timeout", path="session")]
    )
    path = tmp_path / "chaos.json"
    path.write_text(json.dumps(sched.to_json()))
    inj, ref_inj = ChaosInjector(sched), RefInjector(RefSchedule.from_file(path))
    kw = dict(max_batch=4, use_kernel=False, underfill_rows=1024,
              decision_depth=64, dispatch_timeout=0.1, retry=2)
    ours, ref = _engines(**kw)
    ours.chaos, ref.chaos = inj, ref_inj
    events = []
    for i, (name, n, slo) in enumerate([
            ("ccsds-k7", 90, "throughput"), ("ccsds-k7", 80, "throughput"),
            ("ccsds-k7", 300, "latency"), ("lte-tbcc", 40, "latency"),
            ("wifi-11a-r34", 120, "throughput")]):
        for j in range(2):
            llr = _llrs(name, n, 20 + 3 * i + j, flushed=False)
            k = dict(code=name, slo=slo)
            events.append(("submit", (DecodeRequest(llrs=llr, **k),
                                      RefRequest(llrs=llr, **k)), 0.0))
    events.append(("drain", 0.0))
    rng = np.random.default_rng(4)
    events += [("open", "ccsds-k7", sid, 1.0) for sid in ("a", "b")]
    for r in range(4):
        for sid in ("a", "b"):
            llr = np.round(4 * rng.normal(1.0, 1.0, (64, 2))).astype(np.float32)
            events.append(("chunk", sid, llr, 1.0 + r))
        events.append(("poll", 1.5 + r))
    events += [("drain", 9.0), ("close", "a", 9.0), ("close", "b", 9.0), ("drain", 9.5)]
    tickets, tails = _replay(ours, ref, events)
    for got, want in tickets:
        _same_ticket(got, want)
    for got, want in tails:
        np.testing.assert_array_equal(got, np.asarray(want))
    s = ours.stats()
    assert s == ref.stats()
    assert s["degraded"] == 1 and s["failed"] == 2 and s["failovers"] == 3
    assert s["faults"] == {"compile_error": 3, "timeout": 6, "slow": 1,
                           "device_failure": 3}
    assert {t.error for t, _ in tickets} == {None, "decode_failed:DispatchTimeout"}
    assert dict(inj.injected) == dict(ref_inj.injected)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_session_checkpoint_restores_in_the_other_package(writer, use_kernel, tmp_path):
    """Two sessions stream two chunks each in the writer's engine, which
    checkpoints; the other package's engine restores the table and
    streams on; its output equals the writer's own continuation."""
    kw = dict(max_batch=4, use_kernel=use_kernel, decision_depth=128,
              checkpoint_dir=tmp_path)
    ours, ref = _engines(**kw)
    first, second = (ours, ref) if writer == "port" else (ref, ours)
    rng = np.random.default_rng(5)
    chunks = {sid: [np.round(4 * rng.normal(1.0, 1.0, (128, 2))).astype(np.float32)
                    for _ in range(4)] for sid in ("x", "y")}
    for sid in chunks:
        first.open_session("ccsds-k7", sid=sid, now=0.0)
    for r in range(2):
        for sid in chunks:
            first.submit_chunk(sid, chunks[sid][r], now=float(r))
        first.poll(now=float(r))
    first.checkpoint_sessions(now=2.0)
    assert second.restore_sessions(tmp_path, now=2.0) == {"x": 256, "y": 256}
    outs = []
    for eng in (first, second):
        ts = {sid: [eng.submit_chunk(sid, chunks[sid][r], now=3.0 + r)
                    for r in (2, 3)] for sid in chunks}
        eng.drain(now=5.0)
        outs.append({
            sid: np.concatenate([np.asarray(t.bits) for t in ts[sid]]
                                + [np.asarray(eng.close_session(sid, now=6.0))])
            for sid in chunks})
    for sid in chunks:
        assert outs[0][sid].size == 2 * 128 + 128  # two chunks and the ring
        np.testing.assert_array_equal(outs[1][sid], outs[0][sid])


def test_checkpoint_format_equals_the_reference(tmp_path):
    """The port's ``save_sessions`` writes the reference's keys, shapes,
    dtypes and extra; a torn step (arrays without a manifest) is
    skipped by both packages' ``latest_step``."""
    from repro.runtime import checkpoint as ref

    from repro_torch.runtime import checkpoint as ours

    rng = np.random.default_rng(1)
    recs = {sid: {"lam": rng.normal(size=(1, 64)).astype(np.float32),
                  "hist": rng.integers(0, 4, (32, 1, 64)).astype(np.int8),
                  "pos": 40 + i, "code": "ccsds-k7", "consumed": 80 + i}
            for i, sid in enumerate(("b", "a", "s10"))}
    ours.save_sessions(tmp_path / "p", 3, recs, extra={"now": 1.5})
    ref.save_sessions(tmp_path / "r", 3, recs, extra={"now": 1.5})
    mp, mr = (json.loads((tmp_path / d / "step_000000003" / "manifest.json").read_text())
              for d in ("p", "r"))
    for key in ("step", "keys", "shapes", "dtypes", "extra", "status"):
        assert mp[key] == mr[key], key
    for writer in ("p", "r"):
        for mod in (ours, ref):
            step, got, extra = mod.load_sessions(tmp_path / writer)
            assert step == 3 and extra == {"now": 1.5}
            for sid, rec in recs.items():
                for k in ("lam", "hist"):
                    np.testing.assert_array_equal(got[sid][k], rec[k])
                assert [got[sid][k] for k in ("pos", "code", "consumed")] == [
                    rec[k] for k in ("pos", "code", "consumed")]
    torn = tmp_path / "p" / "step_000000009"
    torn.mkdir()
    np.savez(torn / "arrays.npz", x=np.zeros(1))
    assert ours.latest_step(tmp_path / "p") == ref.latest_step(tmp_path / "p") == 3
    assert ours.load_sessions(tmp_path / "empty") == (None, {}, {})


def _kernel_error(*_a, **_k):
    from repro_torch.kernels.viterbi_acs import KernelError

    raise KernelError("acs_forward launch failed: injected")


@pytest.mark.parametrize("where", ["batch", "stream", "session", "shadow"])
def test_kernel_error_escapes_every_guard(where, monkeypatch):
    """A KernelError inside a batch, a stream, a session or a shadow
    dispatch leaves ``drain`` as it is: no retry, no degraded rung, no
    ticket error, no false alarm."""
    import repro_torch.serve.engine as mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.viterbi_acs import KernelError
    from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule, FaultEvent
    from repro_torch.serve import DecodeRequest, make_decode_engine

    kw = dict(max_batch=4, decision_depth=64)
    if where == "stream":
        monkeypatch.setattr(mod, "STREAM_MIN_STEPS", 64)
    if where == "shadow":
        kw.update(scrub=1.0, chaos=ChaosInjector(ChaosSchedule(
            [FaultEvent(at=0, kind="bit_flip", device=0, flips=3)])))
    eng = make_decode_engine(device="cpu", **kw)
    if where == "session":
        eng.open_session(sid="a", now=0.0)
        eng.submit_chunk("a", _llrs("ccsds-k7", 128, 1, flushed=False), now=0.0)
    else:
        n = {"batch": 120, "stream": 256, "shadow": 512}[where]
        t = eng.submit(DecodeRequest(llrs=_llrs("ccsds-k7", n, 2, mu=8.0),
                                     flushed=True), now=0.0)
    # the batch and stream routes launch K1 or K2; the shadow of a batch
    # dispatch is the time-parallel rung, whose K3 fails here
    target = {"batch": "acs_forward", "stream": "acs_decode_fused",
              "session": "acs_decode_fused", "shadow": "transfer_matrix"}[where]
    monkeypatch.setattr(ops, target, _kernel_error)
    with pytest.raises(KernelError, match="injected"):
        eng.drain(now=0.0)
    s = eng.stats()
    assert s["degraded"] == 0 and s["retries"] == 0 and s["failed"] == 0
    assert s["scrub"]["false_alarms"] == 0 and s["faults"] == {}
    if where in ("batch", "stream"):
        assert not t.done and t.error is None
    if where == "shadow":
        assert s["scrub"]["syndrome_flags"] >= 1
        assert s["scrub"]["shadow_dispatches"] == 1


def _as_on_card(monkeypatch):
    """Route the kernel wrappers' CPU tensors through their card launchers
    (device test and sm_90 check stubbed): every check and refusal of the
    launch path runs, up to the build, which has no nvcc here."""
    import torch

    from repro_torch.kernels import viterbi_acs

    monkeypatch.setattr(viterbi_acs, "_one_device", lambda who, *t: torch.device("cuda"))
    monkeypatch.setattr(viterbi_acs, "_check_card", lambda dev, kernel: None)
    monkeypatch.setattr(viterbi_acs, "_sm_count", lambda dev: 132)


def test_other_faults_keep_the_reference_handling(monkeypatch):
    """A kernel wrapper's own refusal on card tensors is a KernelError: it
    leaves ``drain`` with no retry and no rung.  Every other exception is
    handled as in the reference: a RuntimeError outside the kernels is
    retried, then degraded."""
    from repro_torch.core import timeparallel
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.viterbi_acs import KernelRefusal
    from repro_torch.serve import DecodeRequest, make_decode_engine

    def latency_engine():
        eng = make_decode_engine(device="cpu", max_batch=4, retry=1,
                                 underfill_rows=1024)
        t = eng.submit(DecodeRequest(llrs=_llrs("ccsds-k7", 512, 3), slo="latency"),
                       now=0.0)
        return eng, t

    # K3's launcher refuses a cell past its grid
    eng, t = latency_engine()
    with monkeypatch.context() as m:
        _as_on_card(m)
        m.setattr(viterbi_acs, "MAX_GRID_Y", 0)
        with pytest.raises(KernelRefusal, match="more than 0 blocks"):
            eng.drain(now=0.0)
    s = eng.stats()
    assert not t.done and t.error is None
    assert s["degraded"] == 0 and s["retries"] == 0 and s["faults"] == {}

    eng, t = latency_engine()
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        raise RuntimeError("not a kernel fault")

    monkeypatch.setattr(timeparallel, "_suffix_to_final", flaky)
    eng.drain(now=0.0)
    s = eng.stats()
    assert t.error is None and t.path == "batch" and len(calls) == 2
    assert s["degraded"] == 1 and s["retries"] == 1 and s["faults"] == {"error": 2}


@pytest.mark.parametrize("case", ["k1_smem", "k1_w", "k2_smem", "k3_grid", "k2_alloc"])
def test_card_refusals_are_kernel_errors(case, monkeypatch):
    """Every exception of a kernel wrapper on card tensors is a
    KernelError: a refusal a KernelRefusal (also a ValueError, with the
    plain path's message), anything else a KernelError naming the
    launcher; no launch is counted."""
    import torch

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.viterbi_acs import KernelError, KernelRefusal

    _as_on_card(monkeypatch)
    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    S, R, B = tb.n_states, tb.n_slots, tb.llr_block
    w = torch.as_tensor(tb.fused_w)
    blocks, lam0 = torch.zeros(32, 3, B), torch.zeros(3, S)
    hist0 = torch.zeros(64, 3, S // 16, dtype=torch.int32)
    if case == "k1_w":
        w = w.clone()
        w[B:] = w[B:].roll(1, dims=0)
    elif case == "k3_grid":
        monkeypatch.setattr(viterbi_acs, "MAX_GRID_Y", 0)
    elif case == "k2_alloc":
        def no_memory(name):
            raise RuntimeError("CUDA error: out of memory")

        monkeypatch.setattr(viterbi_acs, "_library", no_memory)
    else:
        monkeypatch.setattr(viterbi_acs, "SMEM_LIMIT_BYTES", 0)
    call = {
        "k1": lambda: viterbi_acs.acs_forward(blocks, lam0, w, n_states=S, n_slots=R),
        "k2": lambda: viterbi_acs.acs_decode_fused(
            blocks, lam0, hist0, w, n_states=S, n_slots=R, k=7, rho=2, time_tile=32,
            pack_survivors=True),
        "k3": lambda: viterbi_acs.transfer_matrix(
            blocks, w, n_states=S, n_slots=R, transfer_tile=32),
    }[case[:2]]
    match = {"k1_smem": "shared memory", "k1_w": "other predecessors",
             "k2_smem": "shared memory", "k3_grid": "more than 0 blocks",
             "k2_alloc": "_launch_k2 on the card.*out of memory"}[case]
    before = (viterbi_acs.acs_forward.launches, viterbi_acs.acs_decode_fused.launches,
              viterbi_acs.transfer_matrix.launches)
    with pytest.raises(KernelError, match=match) as info:
        call()
    assert isinstance(info.value, KernelRefusal) == (case != "k2_alloc")
    assert isinstance(info.value, ValueError) == (case != "k2_alloc")
    assert (viterbi_acs.acs_forward.launches, viterbi_acs.acs_decode_fused.launches,
            viterbi_acs.transfer_matrix.launches) == before


def test_card_engine_has_no_plain_rung():
    """An engine on the card degrades a stream cell to batch (K1) only:
    the plain "stream_xla" rung would hide K2.  On the CPU the ladder is
    the reference's."""
    import torch

    from repro_torch.serve import make_decode_engine

    eng = make_decode_engine(device="cpu")
    assert eng._ladder("stream") == ("stream", "stream_xla", "batch")
    assert eng._ladder("time_parallel") == ("time_parallel", "batch")
    eng.device = torch.device("cuda")
    assert eng._ladder("stream") == ("stream", "batch")
    assert eng._ladder("sharded") == ("sharded", "batch")
