"""The streaming slice: ``repro_torch``'s chunked and tiled stream decode
against ``repro``'s, on the same numpy-seeded inputs.

The reference runs as ``tests/test_fused_stream.py`` runs it:
``use_kernel=True``, so its one-pass chunks and windows go through the
Pallas K2 in interpret mode on the CPU, and its two-pass chunks through
the Pallas K1.  The port runs on CPU tensors, so its wrappers take their
plain versions.  Decoded bits, metrics and rings must be identical: on
integer LLRs every sum is exact, and on AWGN LLRs both packages sum in
the same order, so nothing here needs a tolerance.
"""
import numpy as np
import pytest
import torch

K7 = dict(k=7, polys=(0o171, 0o133))


def _specs(k, polys):
    from repro.core.trellis import CodeSpec as RefSpec

    from repro_torch.core import CodeSpec

    return CodeSpec(k=k, polys=polys), RefSpec(k=k, polys=polys)


def _noisy(n_frames, n_bits, sigma, seed, integer=False):
    """(sent bits (F, n), LLRs (F, n, 2) float32) of the K=7 code, BPSK
    with bit 0 -> +1; ``integer`` rounds 4x the LLRs to integers."""
    from repro_torch.core import CODE_K7_CCSDS, conv_encode

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_frames, n_bits))
    llr = np.stack([
        1.0 - 2.0 * conv_encode(b, CODE_K7_CCSDS)
        + rng.normal(0.0, sigma, (n_bits, 2))
        for b in bits
    ])
    if integer:
        llr = np.clip(np.round(4.0 * llr), -16, 16)
    return bits, llr.astype(np.float32)


def _pair(**kw):
    """(port decoder on the CPU, reference decoder with its kernels)."""
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    from repro_torch.core import ViterbiDecoder

    spec, ref_spec = _specs(**K7)
    return (ViterbiDecoder(spec, device="cpu", **kw),
            RefDecoder(ref_spec, use_kernel=True, **kw))


# -- the one-pass rule: the same choice as the reference on every shape ---

RULE_GRID = [
    # (d_steps, t_steps, n_states, packed, time_tile, block_frames)
    (256, 2048, 64, True, None, None),
    (2560, 2048, 64, True, None, None),
    (3040, 2048, 64, True, None, None),  # ring of 3072 steps: at the budget
    (3072, 2048, 64, True, None, None),  # 3104 steps: past it
    (2560, 2048, 64, False, None, None),  # unpacked: past it
    (736, 32, 64, False, None, None),  # unpacked, 768 steps: at it
    (2560, 2048, 64, True, None, 32),
    (2560, 2048, 64, True, None, 512),
    (256, 500, 64, True, None, None),  # common tile 4: below the minimum
    (256, 4, 64, True, None, None),  # a whole 4-step chunk
    (6, 12, 64, True, None, None),  # the whole 6-step depth
    (256, 128, 64, True, 64, None),
    (256, 128, 64, True, 5, None),
    (0, 128, 64, True, None, None),
    (256, 0, 64, True, None, None),
    (128, 256, 4, True, None, None),  # packing impossible
    (128, 256, 4, False, None, None),
    (16, 64, 64, True, None, None),  # the tiled default window
]


@pytest.mark.parametrize("case", RULE_GRID, ids=[str(c) for c in RULE_GRID])
def test_one_pass_rule_matches_reference(case):
    from repro.core.kernel_geometry import one_pass_time_tile as ref_rule

    from repro_torch.core.kernel_geometry import one_pass_time_tile

    assert one_pass_time_tile(*case) == ref_rule(*case)


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("time_tile,block_frames", [
    (None, None), (64, None), (None, 32), (16, 1024),
])
def test_decoder_one_pass_tile_matches_reference(pack, time_tile, block_frames):
    dec, ref = _pair(pack_survivors=pack, time_tile=time_tile,
                     block_frames=block_frames, decision_depth=512)
    assert (dec.one_pass, dec.ring_packed) == (ref.one_pass, ref.ring_packed)
    for t_steps, d_steps in ((128, 256), (2048, 2560), (500, 256),
                             (37, 256), (2048, 3040), (64, 3072)):
        assert dec._one_pass_tile(t_steps, d_steps) == ref._one_pass_tile(
            t_steps, d_steps
        )
    dec.ring_packed = ref.ring_packed = False
    assert dec._one_pass_tile(2048, 2560) == ref._one_pass_tile(2048, 2560)


# -- chunked streaming ----------------------------------------------------

@pytest.mark.parametrize("n", [998, 1000, 1024], ids=["ragged2", "r8", "pow2"])
def test_decode_stream_chunked_matches_reference(n):
    """Remainder chunks whose steps share no usable tile with the depth
    take the two-pass step in both packages; the bits are the same and
    equal a whole-frame decode."""
    import jax.numpy as jnp

    from repro_torch.core import CODE_K7_CCSDS, decode_frames

    sent, llr = _noisy(2, n, 0.5, seed=n)
    dec, ref = _pair(decision_depth=512)
    got = dec.decode_stream_chunked(llr, chunk_len=256)
    assert got.dtype == torch.int32 and got.shape == (2, n)
    want = np.asarray(ref.decode_stream_chunked(jnp.asarray(llr), chunk_len=256))
    np.testing.assert_array_equal(got.numpy(), want)
    full = decode_frames(llr, CODE_K7_CCSDS, initial_state=None,
                         device="cpu")
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    assert (got.numpy() != sent).mean() < 1e-3


@pytest.mark.parametrize("integer", [False, True], ids=["awgn", "integer"])
def test_decode_stream_chunked_pinned(integer):
    """Known start and a tail-flushed end (initial_state and final_state
    pins) recover the sent bits, identically to the reference."""
    import jax.numpy as jnp

    from repro_torch.core import CODE_K7_CCSDS, conv_encode, tail_flush

    rng = np.random.default_rng(6)
    msg = tail_flush(rng.integers(0, 2, 1018), CODE_K7_CCSDS)
    llr = (1.0 - 2.0 * conv_encode(msg, CODE_K7_CCSDS)
           + rng.normal(0.0, 0.4, (len(msg), 2)))
    if integer:
        llr = np.clip(np.round(4.0 * llr), -16, 16)
    llr = llr.astype(np.float32)[None]
    dec, ref = _pair(decision_depth=256)
    kw = dict(chunk_len=256, initial_state=0, final_state=0)
    got = dec.decode_stream_chunked(llr, **kw).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref.decode_stream_chunked(jnp.asarray(llr), **kw))
    )
    np.testing.assert_array_equal(got[0], msg)


def test_decode_chunk_and_flush_step_by_step():
    """Each chunk emits the same bits and leaves the same metrics, ring
    and position as the reference's; so does the flush."""
    import jax.numpy as jnp

    _, llr = _noisy(3, 704, 0.6, seed=11, integer=True)
    dec, ref = _pair(decision_depth=256)
    state = dec.init_stream_state(3, initial_state=0)
    rstate = ref.init_stream_state(3, initial_state=0)
    assert state.hist.dtype == torch.int32 and state.hist.shape == (128, 3, 4)
    emitted = 0
    for lo, hi in ((0, 128), (128, 384), (384, 640), (640, 704)):
        state, bits = dec.decode_chunk(state, llr[:, lo:hi])
        rstate, rbits = ref.decode_chunk(rstate, jnp.asarray(llr[:, lo:hi]))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))
        np.testing.assert_array_equal(state.lam.numpy(), np.asarray(rstate.lam))
        np.testing.assert_array_equal(state.hist.numpy(), np.asarray(rstate.hist))
        assert state.pos == rstate.pos == hi // 2
        emitted += bits.shape[1]
    tail = dec.flush_stream(state)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(ref.flush_stream(rstate)))
    assert emitted + tail.shape[1] == 704


def test_decode_chunk_multi_sessions_at_different_positions():
    """Two sessions stacked into one dispatch, one of them a chunk ahead,
    emit what each emits when driven alone (and what the reference's
    multi-session step emits)."""
    import jax.numpy as jnp

    _, a = _noisy(2, 768, 0.6, seed=12)
    _, b = _noisy(3, 512, 0.6, seed=13)
    dec, ref = _pair(decision_depth=256)
    sa, _ = dec.decode_chunk(dec.init_stream_state(2), a[:, :256])
    sb = dec.init_stream_state(3)
    rsa, _ = ref.decode_chunk(ref.init_stream_state(2), jnp.asarray(a[:, :256]))
    rsb = ref.init_stream_state(3)
    for lo in (256, 512):
        ca, cb = a[:, lo:lo + 256], b[:, lo - 256:lo]
        (na, nb), (oa, ob) = dec.decode_chunk_multi([sa, sb], [ca, cb])
        alone_a, want_a = dec.decode_chunk(sa, ca)
        alone_b, want_b = dec.decode_chunk(sb, cb)
        (rsa, rsb), (ra, rb) = ref.decode_chunk_multi(
            [rsa, rsb], [jnp.asarray(ca), jnp.asarray(cb)]
        )
        for got, alone, want, r in ((oa, want_a, na, ra), (ob, want_b, nb, rb)):
            np.testing.assert_array_equal(got.numpy(), alone.numpy())
            np.testing.assert_array_equal(got.numpy(), np.asarray(r))
        for new, alone in ((na, alone_a), (nb, alone_b)):
            assert new.pos == alone.pos
            assert torch.equal(new.lam, alone.lam)
            assert torch.equal(new.hist, alone.hist)
        sa, sb = na, nb
    assert (sa.pos, sb.pos) == (384, 256)
    assert dec.decode_chunk_multi([], []) == ([], [])
    with pytest.raises(ValueError, match="mixed chunk lengths"):
        dec.decode_chunk_multi([sa, sb], [a[:, :8], b[:, :16]])


def test_radix8_stream_keeps_an_int8_ring():
    """At rho = 3 the reference packs its streaming ring although 16
    slots of 3 bits do not fit a word (fault R1); the port keeps an int8
    ring and streams what the reference's unpacked two-pass path does."""
    import jax.numpy as jnp

    sent, llr = _noisy(2, 1152, 0.5, seed=17)
    dec, ref = _pair(rho=3, decision_depth=384)
    assert ref.ring_packed and not dec.ring_packed
    assert dec._one_pass_tile(128, 128) == 32  # K2 takes the chunks
    _, ref2 = _pair(rho=3, decision_depth=384, one_pass=False)
    got = dec.decode_stream_chunked(llr, chunk_len=384)
    want = ref2.decode_stream_chunked(jnp.asarray(llr), chunk_len=384)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != sent).mean() < 1e-3


def test_norenorm_stream_goes_through_the_guard():
    """A bf16 carry without per-step renorm drifts past its headroom;
    the guard renormalises between chunks in both packages alike."""
    import jax.numpy as jnp
    from repro.core.decoder import ViterbiDecoder as RefDecoder
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core import AcsPrecision, ViterbiDecoder

    _, llr = _noisy(2, 2560, 0.5, seed=14)
    llr = np.round(llr)  # integer, and small enough to drift slowly
    spec, ref_spec = _specs(**K7)
    dec = ViterbiDecoder(
        spec, precision=AcsPrecision(carry_dtype=torch.bfloat16, renorm=False),
        decision_depth=256, device="cpu",
    )
    ref = RefDecoder(
        ref_spec, use_kernel=True, decision_depth=256,
        precision=RefPrecision(carry_dtype=jnp.bfloat16, renorm=False),
    )
    got = dec.decode_stream_chunked(llr, chunk_len=256, initial_state=0)
    want = ref.decode_stream_chunked(jnp.asarray(llr), chunk_len=256,
                                     initial_state=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert dec.renorm_guard.renorms >= 1
    assert dec.renorm_guard.stats() == ref.renorm_guard.stats()


def test_stream_weights_carried_across():
    """Tables rebuilt from the reference's arrays (its fused W included)
    stream the same bits as the port's own tables."""
    from repro.core.trellis import build_acs_tables as ref_tables

    from repro_torch.core import tables_from_numpy

    _, llr = _noisy(2, 640, 0.6, seed=15)
    dec, _ = _pair(decision_depth=256)
    own = dec.decode_stream_chunked(llr, chunk_len=256)
    ref = ref_tables(_specs(**K7)[1], 2)
    dec.tables = tables_from_numpy(dec.spec, 2, {
        name: np.asarray(getattr(ref, name))
        for name in ("theta_t", "pred_onehot", "pred_state", "dec_bits",
                     "fused_w")
    })
    assert torch.equal(dec.decode_stream_chunked(llr, chunk_len=256), own)


def test_stream_dispatch_counts_paths():
    """The dispatch counter names the path each chunk took."""
    from repro_torch.obs.metrics import MetricsRegistry, set_default_registry

    reg = MetricsRegistry()
    old = set_default_registry(reg)
    try:
        _, llr = _noisy(1, 1000, 0.6, seed=16)
        dec, _ = _pair(decision_depth=512)
        dec.decode_stream_chunked(llr, chunk_len=256)  # 3 x 128 steps + 116
        dec.decode_stream_tiled(llr[0])
    finally:
        set_default_registry(old)
    counts = {
        labels["path"]: n
        for labels, n in reg.counter("decoder_dispatch_total").series()
    }
    assert counts == {"chunk_one_pass": 3, "chunk_two_pass": 1, "tiled": 1}


# -- tiled streaming ------------------------------------------------------

@pytest.mark.parametrize("one_pass", [True, False], ids=["one-pass", "two-pass"])
def test_tiled_decode_stream_matches_reference(one_pass):
    import jax.numpy as jnp
    from repro.core.viterbi import tiled_decode_stream as ref_tiled

    from repro_torch.core import TiledDecoderConfig, tiled_decode_stream

    spec, ref_spec = _specs(**K7)
    sent, llr = _noisy(1, 1290, 0.4, seed=9)
    cfg = TiledDecoderConfig()
    got = tiled_decode_stream(llr[0], spec, cfg, one_pass=one_pass,
                              device="cpu")
    assert got.dtype == torch.int32 and got.shape == (1290,)
    want = ref_tiled(jnp.asarray(llr[0]), ref_spec, cfg, use_kernel=True,
                     one_pass=one_pass)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != sent[0]).mean() < 1e-3


def test_decode_stream_tiled_front_door():
    """The decoder routes windows through K2 (its plain version here) by
    default, and through the two-pass path with ``one_pass=False``;
    other tile choices follow the same rule as the reference."""
    import jax.numpy as jnp

    from repro_torch.core import TiledDecoderConfig

    _, llr = _noisy(1, 1024, 0.5, seed=10, integer=True)
    for kw in ({}, {"one_pass": False}, {"time_tile": 8}):
        dec, ref = _pair(**kw)
        for cfg in (None, TiledDecoderConfig(frame_len=96, overlap=48)):
            got = dec.decode_stream_tiled(llr[0], cfg)
            want = ref.decode_stream_tiled(jnp.asarray(llr[0]), cfg)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- K2's walk through per-tile state maps, modelled on the CPU -----------

def _model_in_place_of_plain_k2(monkeypatch):
    """Route the port's K2 wrapper, on CPU tensors, through the model of
    the CUDA kernel's walk (``acs_decode_fused_maps_ref``) instead of the
    plain version's straight walk; returns the list of its calls."""
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import acs_decode_fused_maps_ref

    calls = []

    def model(*args, **kw):
        calls.append(kw["time_tile"])
        return acs_decode_fused_maps_ref(*args, **kw)

    monkeypatch.setattr(viterbi_acs, "acs_decode_fused_ref", model)
    return calls


@pytest.mark.parametrize("integer", [False, True], ids=["awgn", "integer"])
def test_map_walk_model_streams_as_the_reference(monkeypatch, integer):
    """With K2's per-tile-map walk in place of the straight walk, each
    chunk of the stateful stream emits the reference's bits (its Pallas
    K2 in interpret mode) and leaves its metrics and ring, and so does
    the flush: the maps visit the states the reference's walk visits."""
    import jax.numpy as jnp

    calls = _model_in_place_of_plain_k2(monkeypatch)
    _, llr = _noisy(3, 704, 0.6, seed=14, integer=integer)
    dec, ref = _pair(decision_depth=256)
    state = dec.init_stream_state(3, initial_state=0)
    rstate = ref.init_stream_state(3, initial_state=0)
    for lo, hi in ((0, 128), (128, 384), (384, 640), (640, 704)):
        state, bits = dec.decode_chunk(state, llr[:, lo:hi])
        rstate, rbits = ref.decode_chunk(rstate, jnp.asarray(llr[:, lo:hi]))
        np.testing.assert_array_equal(bits.numpy(), np.asarray(rbits))
        np.testing.assert_array_equal(state.lam.numpy(), np.asarray(rstate.lam))
        np.testing.assert_array_equal(state.hist.numpy(), np.asarray(rstate.hist))
    np.testing.assert_array_equal(dec.flush_stream(state).numpy(),
                                  np.asarray(ref.flush_stream(rstate)))
    assert len(calls) == 4


def test_map_walk_model_tiled_as_the_reference(monkeypatch):
    """The tiled decode's one K2 call over all windows, with the map walk,
    decodes the reference's bits (tile 16 over 16-step depths: one map
    of lookahead a window)."""
    import jax.numpy as jnp
    from repro.core.viterbi import tiled_decode_stream as ref_tiled

    from repro_torch.core import TiledDecoderConfig, tiled_decode_stream

    calls = _model_in_place_of_plain_k2(monkeypatch)
    spec, ref_spec = _specs(**K7)
    _, llr = _noisy(1, 1290, 0.5, seed=15, integer=True)
    cfg = TiledDecoderConfig()
    got = tiled_decode_stream(llr[0], spec, cfg, one_pass=True, device="cpu")
    want = ref_tiled(jnp.asarray(llr[0]), ref_spec, cfg, use_kernel=True,
                     one_pass=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls


@pytest.mark.parametrize("integer", [False, True], ids=["awgn", "integer"])
def test_radix8_tiled_one_pass_keeps_an_int8_ring(monkeypatch, integer):
    """``decode_stream_tiled`` at rho = 3 with one-pass on: the reference
    packs the windows' ring although 16 slots of 3 bits do not fit a word
    (fault R1), so it is held here with its ring forced unpacked
    (``repro.core.viterbi.ring_auto_packed`` patched for this test); and
    where the overlap lets survivor paths merge, the port's one-pass
    windows give the reference's two-pass bits too."""
    import jax.numpy as jnp
    import repro.core.viterbi as ref_viterbi

    from repro_torch.core import TiledDecoderConfig, tiled_decode_stream

    spec, ref_spec = _specs(k=5, polys=(0o23, 0o35))
    rng = np.random.default_rng(21)
    n = 64
    from repro_torch.core import conv_encode

    llr = 1.0 - 2.0 * conv_encode(rng.integers(0, 2, n), spec)
    llr = llr + rng.normal(0.0, 0.8, llr.shape)
    if integer:
        llr = np.clip(np.round(2.0 * llr), -4, 4)
    llr = llr.astype(np.float32)
    cfg = TiledDecoderConfig(frame_len=30, overlap=3, rho=3)
    got = tiled_decode_stream(llr, spec, cfg, one_pass=True, device="cpu")
    monkeypatch.setattr(ref_viterbi, "ring_auto_packed", lambda *a, **k: False)
    want = ref_viterbi.tiled_decode_stream(
        jnp.asarray(llr), ref_spec, ref_viterbi.TiledDecoderConfig(
            frame_len=30, overlap=3, rho=3), use_kernel=True, one_pass=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    sent = rng.integers(0, 2, 600)
    llr = 1.0 - 2.0 * conv_encode(sent, spec) + rng.normal(0.0, 0.5, (600, 2))
    llr = llr.astype(np.float32)
    if integer:
        llr = np.clip(np.round(2.0 * llr), -4, 4)
    cfg = TiledDecoderConfig(frame_len=60, overlap=36, rho=3)
    got = tiled_decode_stream(llr, spec, cfg, one_pass=True, device="cpu")
    want = ref_viterbi.tiled_decode_stream(
        jnp.asarray(llr), ref_spec, ref_viterbi.TiledDecoderConfig(
            frame_len=60, overlap=36, rho=3), use_kernel=True, one_pass=False,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != sent).mean() < 1e-2
