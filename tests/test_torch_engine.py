"""The serving slice: ``repro_torch.serve.engine.DecodeEngine`` against
``repro.serve.engine.DecodeEngine`` on the same request traces.

One trace, made from numpy seeds, is replayed into both engines on the
virtual clock, with ``use_kernel`` and ``underfill_rows`` passed alike
(the port's defaults differ: ``use_kernel=True``, and the card's row
budget).  Every ticket's bits, path, cell, error, retries and timing, the
order in which ``poll`` and ``drain`` return them, and ``stats()`` must be
equal.  Engine bits are held to the reference's decoded bits, never to
the sent bits (R3).  The reference's kernels run in interpret mode on the
CPU where ``use_kernel=True``; the port's wrappers run their plain
versions on CPU tensors.
"""
import numpy as np
import pytest
import torch

from tests._torch_serving import (
    _engines,
    _llrs,
    _replay,
    _requests,
    _same_done,
    _same_ticket,
)


def _session_events(seed, code="ccsds-k7", n_chunks=3, c=64):
    """Three tenants in a table of two: the third's opening evicts the
    first; chunks interleave with polls; the rest close."""
    from repro_torch.codes import get_code

    rng = np.random.default_rng(seed)
    beta = get_code(code).spec.beta
    ev = [("open", code, "a", 0.0), ("open", code, "b", 0.0)]
    for r in range(n_chunks):
        for sid in ("a", "b") if r == 0 else (("b", "c") if r > 1 else ("a", "b")):
            llr = np.round(4 * rng.normal(1.0, 1.0, (c, beta))).astype(np.float32)
            ev.append(("chunk", sid, llr, 0.1 * r))
        ev.append(("poll", 0.1 * r + 0.05))
        if r == 1:
            ev.append(("open", code, "c", 0.2))
            ev.append(("evicted", "a"))
    ev += [("close", "b", 1.0), ("close", "c", 1.0), ("drain", 1.0)]
    return ev


def test_replay_equals_the_reference_every_code():
    """The whole trace: every registry code, latency and throughput,
    flushed and unflushed, a sanitised NaN, a request refused with a
    non-finite sample, deadlines shed at the door and in the queue,
    backpressure drops, and sessions with an eviction, on the plain
    paths (``use_kernel=False``); latency cells underfill a budget of
    1024 rows, so the time-parallel route is taken."""
    from repro.serve.engine import DecodeRequest as RefRequest

    from repro_torch.serve import DecodeRequest

    kw = dict(max_batch=4, use_kernel=False, underfill_rows=1024,
              decision_depth=96, session_capacity=2, max_pending=48)
    ours, ref = _engines(**kw)
    reqs = _requests(seed=11)
    events = [("submit", r, 0.0001 * i) for i, r in enumerate(reqs)]
    bad = _llrs("ccsds-k7", 80, 5, flushed=False)
    bad[3, 1] = np.nan
    events.append(("submit", (DecodeRequest(llrs=bad), RefRequest(llrs=bad)), 0.01))
    late = _llrs("ccsds-k7", 64, 6)
    events.append(("submit", (DecodeRequest(llrs=late, slo="latency", deadline=0.0),
                              RefRequest(llrs=late, slo="latency", deadline=0.0)), 0.01))
    events.append(("submit", (DecodeRequest(llrs=late, slo="latency", deadline=0.0105),
                              RefRequest(llrs=late, slo="latency", deadline=0.0105)), 0.01))
    events.append(("poll", 0.02))
    events += _session_events(seed=3)
    # backpressure: more than max_pending waiting before the next poll
    for i in range(55):
        llr = _llrs("ccsds-k7", 64 + i, 100 + i, flushed=False)
        events.append(("submit", (DecodeRequest(llrs=llr), RefRequest(llrs=llr)), 2.0))
    events.append(("drain", 2.5))
    tickets, tails = _replay(ours, ref, events)
    for got, want in tickets:
        _same_ticket(got, want)
    for got, want in tails:
        np.testing.assert_array_equal(got, np.asarray(want))
    s, r = ours.stats(), ref.stats()
    assert s == r
    paths = s["paths"]
    assert {"batch", "time_parallel", "wava", "session"} <= set(paths)
    assert s["rejected"] > 0 and s["expired"] == 2 and s["invalid"] == 1
    assert s["sessions_evicted"] == 1
    assert [b["tickets"] for b in ours.batch_log] == [b["tickets"] for b in ref.batch_log]


def test_sanitize_counts_into_the_engine_registry():
    from repro.serve.engine import DecodeRequest as RefRequest

    from repro_torch.serve import DecodeRequest

    ours, ref = _engines(use_kernel=False, sanitize=True)
    llr = _llrs("ccsds-k7", 80, 9, flushed=False)
    llr[[2, 5], 0] = [np.nan, np.inf]
    llr[7, 1] = -1e6
    t, t_ref = ours.submit(DecodeRequest(llrs=llr), now=0.0), ref.submit(
        RefRequest(llrs=llr), now=0.0)
    ours.drain(now=0.0)
    ref.drain(now=0.0)
    _same_ticket(t, t_ref)
    assert ours.stats() == ref.stats()
    assert ours.stats()["sanitized"] == 3
    fam = ours.registry.counter("decoder_input_sanitized_total")
    assert fam.value(reason="nan", where="engine") == 1
    assert fam.value(reason="clamped", where="engine") == 2


@pytest.mark.parametrize("slo", ["soft", "stream"])
def test_kernel_routes_equal_the_reference(slo, monkeypatch):
    """With the kernels on both sides (the reference's in interpret
    mode): the soft route (K3-LOGPROB; LLRs at atol 1e-4, bits exact)
    and the stream route (K2), the latter reached at 256 steps with
    ``STREAM_MIN_STEPS`` lowered alike in both modules."""
    import repro.serve.engine as ref_mod

    import repro_torch.serve.engine as mod
    from repro.serve.engine import DecodeRequest as RefRequest

    from repro_torch.serve import DecodeRequest

    monkeypatch.setattr(mod, "STREAM_MIN_STEPS", 128)
    monkeypatch.setattr(ref_mod, "STREAM_MIN_STEPS", 128)
    ours, ref = _engines(max_batch=4, use_kernel=True, underfill_rows=0,
                         decision_depth=128)
    pairs = []
    for i, (n, flushed) in enumerate([(512, True), (500, False), (300, False)]):
        llr = _llrs("ccsds-k7", n, 40 + i, flushed=flushed)
        kw = dict(slo="soft" if slo == "soft" else "throughput", flushed=flushed)
        pairs.append((ours.submit(DecodeRequest(llrs=llr, **kw), now=0.0),
                      ref.submit(RefRequest(llrs=llr, **kw), now=0.0)))
    _same_done(ours.drain(now=0.0), ref.drain(now=0.0))
    for got, want in pairs:
        _same_ticket(got, want, soft_atol=1e-4)
    want_path = "soft" if slo == "soft" else "stream"
    assert {got.path for got, _ in pairs} == {want_path}
    assert ours.stats() == ref.stats()


def test_routes_equal_direct_decoder_calls():
    """Every route's bits are those of a direct call of the entry point
    it names, on the unpadded frames (initial state 0, final state 0
    only for flushed frames): the padding lemma, on the port alone."""
    from repro_torch.core import ViterbiDecoder
    from repro_torch.distributed import frame_mesh
    from repro_torch.serve import DecodeRequest, make_decode_engine

    mesh = frame_mesh(2, device="cpu")
    eng = make_decode_engine(device="cpu", max_batch=4, use_kernel=False,
                             underfill_rows=1024, mesh=mesh)
    cases = [("ccsds-k7", 100, "throughput", False),
             ("ccsds-k7", 96, "throughput", True),
             ("ccsds-k7", 300, "latency", False),
             ("wifi-11a-r34", 120, "throughput", False),
             ("lte-tbcc", 40, "latency", False)]
    subs = []
    for i, (name, n, slo, flushed) in enumerate(cases):
        for j in range(2):
            llr = _llrs(name, n, 70 + 5 * i + j, flushed=flushed)
            subs.append((name, flushed, llr, eng.submit(DecodeRequest(
                llrs=llr, code=name, slo=slo, flushed=flushed), now=0.0)))
    eng.drain(now=0.0)
    assert {t.path for *_, t in subs} == {"sharded", "time_parallel", "wava"}
    for name, flushed, llr, t in subs:
        dec = ViterbiDecoder.from_standard(name, use_kernel=False, device="cpu")
        x = torch.from_numpy(llr[None])
        fin = 0 if flushed else None
        if t.path == "wava":
            want = dec.decode_tailbiting(x)[0]
        elif t.path == "time_parallel":
            want = dec.decode_batch(x, initial_state=0, final_state=fin,
                                    time_parallel=True)
        else:
            want = dec.decode_sharded(x, mesh=mesh, initial_state=0,
                                      final_state=fin)
        np.testing.assert_array_equal(t.bits, want[0].numpy())


def test_cell_rungs_equal_the_reference():
    from repro.core.kernel_geometry import ENGINE_MIN_CELL as REF_MIN
    from repro.core.kernel_geometry import pick_cell_frames as ref_frames
    from repro.core.kernel_geometry import pick_cell_length as ref_length

    from repro_torch.core.kernel_geometry import (
        ENGINE_MIN_CELL,
        pick_cell_frames,
        pick_cell_length,
    )

    assert ENGINE_MIN_CELL == REF_MIN
    for n in (1, 63, 64, 65, 1000, 4096, 4097, 12000):
        for mult in (1, 3, 4, 7):
            for lo in (16, 64):
                assert pick_cell_length(n, lo, mult) == ref_length(n, lo, mult)
        for cap in (1, 4, 48, 64):
            assert pick_cell_frames(n, cap) == ref_frames(n, cap)
    with pytest.raises(ValueError):
        pick_cell_length(0)


def test_engine_constants_equal_the_reference():
    import repro.serve.engine as ref

    import repro_torch.serve.engine as ours

    for name in ("SLO_CLASSES", "DEFAULT_MAX_WAIT", "STREAM_MIN_STEPS",
                 "DEGRADATION_LADDER"):
        assert getattr(ours, name) == getattr(ref, name), name


def test_callable_cache_counts_hits_and_misses():
    from repro_torch.serve import DecodeRequest, make_decode_engine

    eng = make_decode_engine(device="cpu", max_batch=2, use_kernel=False)
    for r in range(3):
        eng.decode([DecodeRequest(llrs=_llrs("ccsds-k7", 60, 10 * r + i,
                                             flushed=False)) for i in range(2)])
        assert eng.stats()["jit_cache"] == {"hits": r, "misses": 1, "entries": 1}


def test_requests_must_be_shaped_as_their_code_says():
    from repro_torch.serve import DecodeRequest, make_decode_engine

    eng = make_decode_engine(device="cpu", use_kernel=False)
    with pytest.raises(ValueError, match="serial"):
        eng.submit(DecodeRequest(llrs=np.zeros((8, 2), np.float32),
                                 code="wifi-11a-r34"))
    with pytest.raises(ValueError, match="beta=2"):
        eng.submit(DecodeRequest(llrs=np.zeros(8, np.float32)))
    with pytest.raises(ValueError, match="SLO"):
        eng.submit(DecodeRequest(llrs=np.zeros((8, 2), np.float32), slo="bulk"))
    with pytest.raises(KeyError):
        eng.submit(DecodeRequest(llrs=np.zeros((8, 2), np.float32), code="nope"))
    sid = eng.open_session()
    with pytest.raises(ValueError, match="rho"):
        eng.submit_chunk(sid, np.zeros((7, 2), np.float32))
    with pytest.raises(ValueError, match="already open"):
        eng.open_session(sid=sid)


def test_engine_defaults_to_the_card():
    from repro_torch.serve import make_decode_engine

    if torch.cuda.is_available():
        assert make_decode_engine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_decode_engine()
    eng = make_decode_engine(device="cpu")
    assert eng.use_kernel and eng._decoder("ccsds-k7").device.type == "cpu"


def test_recorder_spans_close_after_the_device_wait():
    """A recorder-enabled run records the lifecycle spans and one
    ``engine_dispatch_seconds`` sample a dispatch, the sample at least
    the ``engine.device_wait`` span that closes inside it."""
    from repro_torch.obs import SpanRecorder
    from repro_torch.serve import DecodeRequest, make_decode_engine

    rec = SpanRecorder()
    eng = make_decode_engine(device="cpu", use_kernel=False, recorder=rec)
    eng.decode([DecodeRequest(llrs=_llrs("ccsds-k7", 80, i, flushed=False))
                for i in range(3)])
    names = {s.name for s in rec.spans}
    assert {"engine.batch", "engine.assemble", "engine.jit_lookup",
            "engine.dispatch", "engine.device_wait", "engine.emit"} <= names
    (disp,), (wait,) = rec.find("engine.dispatch"), rec.find("engine.device_wait")
    assert wait.parent == disp.id and disp.t0 <= wait.t0 <= wait.t1 <= disp.t1
    hist = eng.registry.histogram("engine_dispatch_seconds")
    assert hist.count() == 1 and hist.sum_() >= wait.duration
    assert rec.open_spans == 0
