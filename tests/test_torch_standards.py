"""The standard-codes slice, part 2: ``ViterbiDecoder.from_standard`` for
every registry code, through every entry point, against ``repro``'s on
the same numpy-seeded inputs: punctured serial streams, tail-biting
frames, streaming and soft output.

Both sides take the same path: ``use_kernel`` and ``time_parallel`` are
paired alike (the reference's K1 ignores ``split_dot``, R6, and on ties
the time-parallel decode need not be an ML path, R5).  The reference's
kernels run in interpret mode on the CPU where ``use_kernel=True``; the
port's wrappers take their plain versions on CPU tensors.  Hard bits are
held exactly (integer LLRs: every f32 sum exact), soft LLRs and list
metrics at atol 1e-4, the tolerance of the reference's own soft tests.
"""
import numpy as np
import pytest
import torch

CODES = ["ccsds-k7", "dvb-s", "dvb-s-r78", "gsm-cs1", "lte-tbcc", "wifi-11a",
         "wifi-11a-r23", "wifi-11a-r34", "wifi-11a-r56"]
PUNCTURED = ["dvb-s-r78", "wifi-11a-r23", "wifi-11a-r34", "wifi-11a-r56"]
OPEN = [c for c in CODES if c != "lte-tbcc"]
# the reference's interpret-mode kernels are slow: the kernel pairing runs
# on one code of each kind
KERNEL_CODES = ["wifi-11a-r34", "lte-tbcc"]
BATCH_CASES = ([(c, p) for c in CODES for p in ("seq", "timepar")]
               + [(c, "kernel") for c in KERNEL_CODES])
STREAM_CASES = [(c, False) for c in OPEN] + [("wifi-11a-r34", True)]
SOFT_CASES = [(c, False) for c in CODES] + [(c, True) for c in KERNEL_CODES]


def _llrs(name, n_frames, n_bits, seed, sigma=0.6, integer=True, rho=2):
    """(message bits (F, n_bits), LLRs) of a registry code: the tx frame
    (message + the rho-aligned zero tail, or tail-biting), BPSK with the
    bpsk convention (bit 0 -> +1) plus Gaussian noise, integer-rounded
    when ``integer``; the serial kept stream (F, Lp) for a punctured code,
    else (F, n, beta)."""
    from repro_torch.codes import get_code
    from repro_torch.core import conv_encode

    code = get_code(name)
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_frames, n_bits))
    tx = bits
    if code.termination == "zero":
        tail = code.spec.k - 1
        tail += (-(n_bits + tail)) % rho
        tx = np.concatenate([bits, np.zeros((n_frames, tail), np.int64)], axis=1)
    coded = np.stack([
        conv_encode(b, code.spec, tail_bite=code.termination == "tailbiting")
        for b in tx
    ])
    llr = 1.0 - 2.0 * coded + rng.normal(0.0, sigma, coded.shape)
    if integer:
        llr = np.clip(np.round(4.0 * llr), -16, 16)
    if code.puncture is not None:
        idx = code.puncture.kept_indices(coded.shape[1])
        llr = llr.reshape(n_frames, -1)[:, idx]
    return bits, llr.astype(np.float32)


def _pair(name, **kw):
    """(port decoder on the CPU, reference decoder), built alike."""
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    from repro_torch.core import ViterbiDecoder

    return (ViterbiDecoder.from_standard(name, device="cpu", **kw),
            RefDecoder.from_standard(name, **kw))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", CODES)
def test_geometry_equals_the_reference(name):
    for depth in (5120, 1000, 64):
        dec, ref = _pair(name, decision_depth=depth, use_kernel=True)
        assert dec.decision_depth == ref.decision_depth
        assert dec.ring_packed == ref.ring_packed
        got, want = dec.default_tiled_config(), ref.default_tiled_config()
        assert (got.frame_len, got.overlap, got.rho) == (
            want.frame_len, want.overlap, want.rho)
        assert (dec.puncture is None) == (ref.puncture is None)
        assert dec.termination == ref.termination


@pytest.mark.parametrize("name,path", BATCH_CASES)
def test_decode_batch_equals_the_reference(name, path):
    """Serial punctured input and the shaped (depunctured) input give the
    reference's bits on one path: sequential plain, sequential through
    K1, time-parallel (transfer tile 8) plain."""
    import jax.numpy as jnp

    from repro_torch.codes.puncture import depuncture

    kw = dict(use_kernel=path == "kernel", time_parallel=path == "timepar",
              transfer_tile=8)
    dec, ref = _pair(name, **kw)
    _, llr = _llrs(name, 3, 120, seed=len(name))
    want = np.asarray(ref.decode_batch(jnp.asarray(llr)))
    got = dec.decode_batch(llr)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    _eq(got, want)
    if dec.puncture is not None:
        _eq(dec.decode_batch(depuncture(torch.as_tensor(llr), dec.puncture)), want)


def test_decode_batch_shapes_are_checked_after_depuncturing():
    from repro_torch.core import ViterbiDecoder
    from repro_torch.core.validate import InvalidInputError

    dec = ViterbiDecoder.from_standard("wifi-11a-r34", device="cpu")
    with pytest.raises(InvalidInputError, match="beta=2"):
        dec.decode_batch(torch.zeros(2, 6, 3))
    tb = ViterbiDecoder.from_standard("lte-tbcc", device="cpu")
    with pytest.raises(InvalidInputError, match="beta=3"):
        tb.decode_batch(torch.zeros(2, 6, 2))


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("n_bits", [128, 61])
def test_decode_tailbiting_equals_the_reference(n_bits, tp):
    """(bits, converged) of lte-tbcc, at an even length (rho=2 tables)
    and an odd one (rho=1 tables), sequential and time-parallel."""
    import jax.numpy as jnp

    dec, ref = _pair("lte-tbcc", time_parallel=tp, transfer_tile=8)
    bits, llr = _llrs("lte-tbcc", 4, n_bits, seed=n_bits, sigma=1.0)
    got_b, got_c = dec.decode_tailbiting(llr, max_iters=3)
    want_b, want_c = ref.decode_tailbiting(jnp.asarray(llr), max_iters=3)
    _eq(got_b, want_b)
    _eq(got_c, want_c)
    _eq(dec.decode_batch(llr), ref.decode_batch(jnp.asarray(llr)))


def test_termination_override_decodes_a_zero_code_circularly():
    """``decode_batch(termination="tailbiting")`` on a zero-terminated
    code's decoder, as in the reference."""
    import jax.numpy as jnp

    from repro_torch.core import conv_encode

    dec, ref = _pair("ccsds-k7", time_parallel=False)
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (2, 64))
    llr = np.stack([1.0 - 2.0 * conv_encode(b, dec.spec, tail_bite=True)
                    for b in bits]).astype(np.float32)
    got = dec.decode_batch(llr, termination="tailbiting")
    _eq(got, ref.decode_batch(jnp.asarray(llr), termination="tailbiting"))
    _eq(got, bits)


@pytest.mark.parametrize("name,use_kernel", STREAM_CASES)
def test_streams_equal_the_reference(name, use_kernel):
    """``decode_stream_chunked`` on the serial (F, Lp) streams and
    ``decode_stream_tiled`` on one serial (Lp,) stream, one-pass where
    ``use_kernel`` turns it on, as in the reference."""
    import jax.numpy as jnp

    dec, ref = _pair(name, use_kernel=use_kernel, decision_depth=64,
                     time_parallel=False)
    _, llr = _llrs(name, 2, 300, seed=7 + len(name))
    got = dec.decode_stream_chunked(llr, chunk_len=100, initial_state=0)
    _eq(got, ref.decode_stream_chunked(jnp.asarray(llr), chunk_len=100,
                                       initial_state=0))
    got_t = dec.decode_stream_tiled(llr[0])
    _eq(got_t, ref.decode_stream_tiled(jnp.asarray(llr[0])))
    assert got_t.shape == (got.shape[1],)


@pytest.mark.parametrize("name", PUNCTURED)
def test_punctured_chunked_and_tiled_match_batch(name):
    """As ``tests/test_codes.py`` holds the reference: chunked bits equal
    the batch decode's, tiled bits differ only by tiling edge effects,
    and the message comes back at 7 dB."""
    from repro_torch.codes import get_code
    from repro_torch.core.channel import awgn_sigma

    code = get_code(name)
    sigma = awgn_sigma(7.0, code.rate)
    bits, llr = _llrs(name, 1, 2048, seed=13, sigma=sigma, integer=False)
    from repro_torch.core import ViterbiDecoder

    dec = ViterbiDecoder.from_standard(name, decision_depth=512,
                                       time_parallel=False, device="cpu")
    batch = dec.decode_batch(llr, initial_state=None)[0]
    chunked = dec.decode_stream_chunked(llr, chunk_len=500, initial_state=None)[0]
    tiled = dec.decode_stream_tiled(llr[0])
    _eq(chunked, batch)
    assert (tiled != batch).float().mean() < 2e-3
    _eq(batch[:2048], bits[0])


def test_tailbiting_refuses_stream_modes():
    from repro_torch.core import ViterbiDecoder

    dec = ViterbiDecoder.from_standard("lte-tbcc", device="cpu")
    llrs = torch.zeros(1, 60, 3)
    with pytest.raises(ValueError, match="tail-biting|tiled"):
        dec.decode_stream_tiled(llrs[0])
    with pytest.raises(ValueError, match="tail-biting|chunked"):
        dec.decode_stream_chunked(llrs)


@pytest.mark.parametrize("name,use_kernel", SOFT_CASES)
def test_decode_soft_equals_the_reference(name, use_kernel):
    """``llr`` at atol 1e-4, ``bits`` exactly ``llr < 0``'s, ``list``
    bits exactly and metrics at atol 1e-4, on the serial input."""
    import jax.numpy as jnp

    dec, ref = _pair(name, use_kernel=use_kernel)
    _, llr = _llrs(name, 2, 60, seed=3 + len(name), sigma=0.8)
    x = jnp.asarray(llr)
    got = dec.decode_soft(llr, output="llr")
    want = np.asarray(ref.decode_soft(x, output="llr"))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    _eq(dec.decode_soft(llr, output="bits"), (got < 0).to(torch.int32))
    lb, lm = dec.decode_soft(llr, output="list", n_list=3)
    rb, rm = ref.decode_soft(x, output="list", n_list=3)
    _eq(lb, rb)
    np.testing.assert_allclose(lm.numpy(), np.asarray(rm), atol=1e-4, rtol=0)
