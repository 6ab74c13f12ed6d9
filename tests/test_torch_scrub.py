"""The scrubber: ``repro_torch.verify.scrub`` against ``repro.verify.scrub``
(binomial tails, corruption weights, syndrome verdicts, the sampling
policy) and the engine's detect -> confirm -> quarantine loop against
the reference engine's, on the same numpy-seeded frames.

The verdicts are held to the reference's field for field, its blind
spots included: R8's input (dvb-s-r78, seed 7097, mu 7.0, pick 1) stays
unflagged, ``max_window`` 11 against ``threshold`` 16, as there.
"""
import dataclasses

import numpy as np
import pytest

from tests._torch_serving import CODES, _engines, _llrs, _same_ticket

N_BITS = 96


def _clean_frame(name, seed, n, mu):
    """The reference's ``tests/test_scrub.py::_clean_frame``: (message
    bits, LLRs) of one LLR-consistent AWGN frame, the serial kept stream
    for a punctured code."""
    from repro_torch.codes import get_code
    from repro_torch.core import conv_encode

    code = get_code(name)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n).astype(np.int64)
    tb = code.termination == "tailbiting"
    if not tb:
        bits[n - (code.spec.k - 1):] = 0
    coded = conv_encode(bits, code.spec, tail_bite=tb)
    llr = rng.normal(mu * (1.0 - 2.0 * coded), np.sqrt(2.0 * mu)).astype(np.float32)
    if code.puncture is not None:
        llr = llr.reshape(-1)[code.puncture.kept_indices(n)]
    return bits, llr


def _strong_pairs(name):
    """The reference test's positions t where flipping t and t+k clears
    the confident threshold structurally."""
    from repro_torch.codes import get_code
    from repro_torch.verify.scrub import corruption_weight

    code = get_code(name)
    k = code.spec.k
    return [t for t in range(0, N_BITS - 2 * k)
            if corruption_weight(code, t, N_BITS) >= 6
            and corruption_weight(code, t + k, N_BITS) >= 6]


def _verdicts(bits, llr, name):
    from repro.codes.registry import get_code as ref_code
    from repro.verify.scrub import syndrome_check as ref_check

    from repro_torch.codes import get_code
    from repro_torch.verify.scrub import syndrome_check

    return (syndrome_check(bits, llr, get_code(name)),
            ref_check(bits, llr, ref_code(name)))


def test_binom_tail_equals_the_reference():
    from repro.verify.scrub import binom_tail as ref

    from repro_torch.verify.scrub import binom_tail

    for n in (0, 1, 14, 28, 60):
        for p in (0.0, 1e-3, 0.02, 0.3, 1.0):
            for m in (-1, 0, 1, 3, 7, n, n + 1):
                assert binom_tail(n, p, m) == ref(n, p, m)


@pytest.mark.parametrize("name", CODES)
def test_corruption_weight_equals_the_reference(name):
    from repro.codes.registry import get_code as ref_code
    from repro.verify.scrub import corruption_weight as ref

    from repro_torch.codes import get_code
    from repro_torch.verify.scrub import corruption_weight

    for t in (0, 1, 5, 47, 88, 90, 95):
        assert corruption_weight(get_code(name), t, N_BITS) == ref(
            ref_code(name), t, N_BITS)


@pytest.mark.parametrize("name", CODES)
def test_syndrome_verdicts_equal_the_reference(name):
    """Clean frames and clustered two-bit corruptions over seeds and
    SNRs: every field of the verdict equals the reference's."""
    from repro_torch.codes import get_code

    k = get_code(name).spec.k
    pairs = _strong_pairs(name)
    flagged = 0
    for seed in range(4):
        for mu in (3.0, 7.0, 12.0):
            bits, llr = _clean_frame(name, 31 * seed + int(mu), N_BITS, mu)
            got, want = _verdicts(bits, llr, name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert not got.flagged
            bad = bits.copy()
            t = pairs[(7 * seed) % len(pairs)]
            bad[[t, t + k]] ^= 1
            got, want = _verdicts(bad, llr, name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            flagged += got.flagged
    assert flagged >= 8


def test_r8_counterexample_stays_unflagged_as_in_the_reference():
    """R8: the reference's clustered-corruption property fails on this
    input, and the port gives the same verdict."""
    name, seed, mu, pick = "dvb-s-r78", 7097, 7.0, 1
    bits, llr = _clean_frame(name, seed, N_BITS, mu)
    pairs = _strong_pairs(name)
    t = pairs[pick % len(pairs)]
    bad = bits.copy()
    bad[[t, t + 7]] ^= 1
    got, want = _verdicts(bad, llr, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.flagged, got.max_window, got.threshold) == (False, 11, 16)


def test_syndrome_check_refuses_as_the_reference():
    import torch
    from repro.codes.registry import get_code as ref_code
    from repro.verify.scrub import syndrome_check as ref_check

    from repro_torch.codes import get_code
    from repro_torch.core.validate import InvalidInputError
    from repro_torch.verify.scrub import syndrome_check

    bits = np.zeros(32, np.int64)
    for llr, reason in ((np.zeros(64, np.float32), "puncture"),
                        (np.zeros((31, 2), np.float32), "shape"),
                        (np.zeros((32, 3), np.float32), "shape")):
        with pytest.raises(InvalidInputError) as ours:
            syndrome_check(bits, llr, get_code("ccsds-k7"))
        with pytest.raises(Exception) as ref:
            ref_check(bits, llr, ref_code("ccsds-k7"))
        assert ours.value.reason == ref.value.reason == reason
    v = syndrome_check(torch.zeros(32), torch.zeros(32, 2), get_code("ccsds-k7"))
    assert not v.flagged and v.n_compared == 0


def test_scrubber_policy_equals_the_reference():
    from repro.verify.scrub import SHADOW_RUNG as REF_RUNG
    from repro.verify.scrub import SdcScrubber as RefScrubber

    from repro_torch.verify.scrub import SHADOW_RUNG, SdcScrubber

    assert SHADOW_RUNG == REF_RUNG
    for rate in (0.0, 0.25, 0.3, 1.0):
        a, b = SdcScrubber(rate=rate), RefScrubber(rate=rate)
        assert [a.sample() for _ in range(40)] == [b.sample() for _ in range(40)]
        assert a.stats() == b.stats() and a.enabled == b.enabled
        for p in ("batch", "sharded", "stream", "wava", "session"):
            assert a.shadow_path(p) == b.shadow_path(p)
    with pytest.raises(ValueError, match="rate"):
        SdcScrubber(rate=1.5)


@pytest.mark.parametrize("mesh", [False, True])
def test_engine_sdc_loop_equals_the_reference(mesh):
    """A bit_flip corrupts a flushed cell's decoded bits; the sampled
    scrubber flags it, the shadow rung confirms, the ticket fails with
    ``sdc_detected`` and the device is quarantined (and, with a mesh of
    one shard, the mesh is re-planned away), exactly as in the
    reference engine; clean frames of the cell keep their bits."""
    from repro.distributed.decoder import frame_mesh as ref_mesh
    from repro.runtime.chaos import ChaosInjector as RefInjector
    from repro.runtime.chaos import ChaosSchedule as RefSchedule
    from repro.serve.engine import DecodeRequest as RefRequest

    from repro_torch.distributed import frame_mesh
    from repro_torch.runtime.chaos import ChaosInjector, ChaosSchedule, FaultEvent
    from repro_torch.serve import DecodeRequest

    sched = ChaosSchedule([FaultEvent(at=0, kind="bit_flip", device=0, flips=3)])
    ours, ref = _engines(max_batch=8, use_kernel=False, scrub=1.0)
    ours.chaos = ChaosInjector(sched)
    ref.chaos = RefInjector(RefSchedule.from_json(sched.to_json()))
    if mesh:
        ours.mesh, ref.mesh = frame_mesh(1, device="cpu"), ref_mesh()
    pairs = []
    for i in range(8):
        llr = _llrs("ccsds-k7", 128, 300 + i, mu=8.0)
        pairs.append((ours.submit(DecodeRequest(llrs=llr, flushed=True), now=0.0),
                      ref.submit(RefRequest(llrs=llr, flushed=True), now=0.0)))
    ours.drain(now=0.0)
    ref.drain(now=0.0)
    for got, want in pairs:
        _same_ticket(got, want)
    s = ours.stats()
    assert s == ref.stats()
    assert s["scrub"]["confirmed"] >= 1 and s["quarantined"] == [0]
    assert [vars(r) for r in ours.quarantine_log] == [vars(r) for r in ref.quarantine_log]
    assert sum(t.error == "sdc_detected" for t, _ in pairs) == s["scrub"]["confirmed"]
    assert ours.mesh is None and ref.mesh is None
