"""Helpers of the serving tests (``tests/test_torch_{engine,runtime,
scrub,distributed}.py``): numpy-seeded request LLRs, a pair of engines
built alike, and the replay of one event list into both."""
import numpy as np

CODES = ["ccsds-k7", "dvb-s", "dvb-s-r78", "gsm-cs1", "lte-tbcc", "wifi-11a",
         "wifi-11a-r23", "wifi-11a-r34", "wifi-11a-r56"]


def _llrs(name, n_bits, seed, sigma=0.7, flushed=True, mu=None):
    """One request's LLRs of a registry code: message bits (with the zero
    tail of k-1 bits when ``flushed`` and the code is zero-terminated),
    BPSK with bit 0 -> +1 plus Gaussian noise, rounded to quarters, or
    with ``mu`` the LLRs of an AWGN channel at LLR mean ``mu``
    (N(mu * symbol, 2 mu), what the scrubber's model expects); the
    serial kept stream (Lp,) of a punctured code, else (n, beta)."""
    from repro_torch.codes import get_code
    from repro_torch.core import conv_encode

    code = get_code(name)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n_bits)
    tb = code.termination == "tailbiting"
    if flushed and not tb:
        bits[-(code.spec.k - 1):] = 0
    coded = conv_encode(bits, code.spec, tail_bite=tb)
    sym = 1.0 - 2.0 * coded
    if mu is None:
        llr = np.round(4.0 * (sym + rng.normal(0.0, sigma, coded.shape)))
    else:
        llr = rng.normal(mu * sym, np.sqrt(2.0 * mu))
    llr = llr.astype(np.float32)
    if code.puncture is not None:
        llr = llr.reshape(-1)[code.puncture.kept_indices(n_bits)]
    return llr


def _engines(**kw):
    from repro.serve.engine import DecodeEngine as RefEngine

    from repro_torch.serve import make_decode_engine

    return make_decode_engine(device="cpu", **kw), RefEngine(**kw)


def _requests(seed):
    """A mixed trace: every registry code, both hard SLO classes,
    flushed and unflushed frames, ragged lengths sharing rungs."""
    from repro.serve.engine import DecodeRequest as RefRequest

    from repro_torch.serve import DecodeRequest

    out = []
    for i, name in enumerate(CODES):
        tb = name == "lte-tbcc"
        shapes = [(40, "latency", False), (40, "throughput", False)] if tb else [
            (90, "throughput", False), (70, "throughput", False),
            (96, "throughput", True), (300, "latency", False),
            (512, "latency", True),
        ]
        for j, (n, slo, flushed) in enumerate(shapes):
            llr = _llrs(name, n, seed + 37 * i + j, flushed=flushed)
            kw = dict(code=name, slo=slo, flushed=flushed)
            out.append((DecodeRequest(llrs=llr, **kw), RefRequest(llrs=llr, **kw)))
    return out


TICKET_FIELDS = ("id", "code", "slo", "submitted", "n_out", "done", "dropped",
                 "completed", "cell", "path", "error", "retries", "deadline")


def _same_ticket(got, want, soft_atol=None):
    for f in TICKET_FIELDS:
        assert getattr(got, f) == getattr(want, f), (f, got, want)
    if want.bits is None:
        assert got.bits is None
    else:
        assert got.bits.dtype == np.int32
        np.testing.assert_array_equal(got.bits, np.asarray(want.bits))
    if want.llrs is None:
        assert got.llrs is None
    else:
        np.testing.assert_allclose(got.llrs, want.llrs, atol=soft_atol, rtol=0)


def _same_done(got, want):
    assert [t.id for t in got] == [t.id for t in want]


def _replay(ours, ref, events):
    """Apply one event list to both engines; returns the ticket pairs and
    the tails (close_session, evicted_tail) of both."""
    tickets, tails = [], []
    for ev in events:
        op, args = ev[0], ev[1:]
        if op == "submit":
            (req, ref_req), now = args
            tickets.append((ours.submit(req, now=now), ref.submit(ref_req, now=now)))
        elif op in ("poll", "drain"):
            (now,) = args
            _same_done(getattr(ours, op)(now=now), getattr(ref, op)(now=now))
        elif op == "open":
            code, sid, now = args
            assert ours.open_session(code, sid=sid, now=now) == ref.open_session(
                code, sid=sid, now=now)
        elif op == "chunk":
            sid, llr, now = args
            tickets.append((ours.submit_chunk(sid, llr, now=now),
                            ref.submit_chunk(sid, llr, now=now)))
        elif op == "close":
            sid, now = args
            tails.append((ours.close_session(sid, now=now),
                          ref.close_session(sid, now=now)))
        elif op == "evicted":
            (sid,) = args
            tails.append((ours.evicted_tail(sid), ref.evicted_tail(sid)))
    return tickets, tails
