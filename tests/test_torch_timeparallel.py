"""The time-parallel slice: ``repro_torch.core.timeparallel`` and K3's
plain version against ``repro.core.timeparallel`` and the reference's
Pallas K3, which runs in interpret mode on the CPU through
``repro.kernels.ops.viterbi_transfer_matrices`` as the reference's own
tests run it.  Inputs are made with numpy from a seed and handed to both
packages.

Tolerances: none.  On integer LLRs every f32 sum is exact, so transfer
matrices, entry metrics and suffix metrics must be bit-identical.  On
Gaussian LLRs the B LLR terms of a potential could in principle be
summed in another order by the reference's dot; both packages sum them
in the same order here, so those too are held bit for bit.  Decoded
bits must be identical
everywhere: to the reference's time-parallel decode, and to the port's
own sequential ``decode_frames`` (Gaussian LLRs, so no two paths tie).

At LOGPROB (the BCJR's formation and scans) exp and log round
differently in each library: matrices and metrics agree to atol 1e-4
(the reference's soft tolerance) on reachable entries, and the -1e9 of
unreachable entries are equal on both sides.
"""
import functools

import numpy as np
import pytest
import torch

def _specs(name="ccsds-k7"):
    from repro.core.trellis import CodeSpec as RefSpec

    from repro_torch.codes import get_code

    spec = get_code(name).spec
    return spec, RefSpec(k=spec.k, polys=spec.polys)


def _precisions(label):
    """(port AcsPrecision, reference AcsPrecision) for a policy label."""
    import jax.numpy as jnp
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core.viterbi import AcsPrecision

    if label == "f32":
        return AcsPrecision(), RefPrecision()
    return (
        AcsPrecision(matmul_dtype=torch.bfloat16,
                     channel_dtype=torch.bfloat16, split_dot=True),
        RefPrecision(matmul_dtype=jnp.bfloat16, channel_dtype=jnp.bfloat16,
                     split_dot=True),
    )


def _llrs(F, n, seed, beta=2, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-8, 9, (F, n, beta)).astype(np.float32)
    return rng.normal(0.0, 1.0, (F, n, beta)).astype(np.float32)


def _blocks(F, n, seed, rho=2, integer=False, name="ccsds-k7"):
    """(port blocks (T', F, B) tensor, reference blocks jnp array)."""
    import jax.numpy as jnp
    from repro.core.viterbi import blocks_from_llrs as ref_blocks

    from repro_torch.core.viterbi import blocks_from_llrs

    spec, _ = _specs(name)
    llrs = _llrs(F, n, seed, spec.beta, integer)
    return (blocks_from_llrs(torch.from_numpy(llrs), rho).contiguous(),
            ref_blocks(jnp.asarray(llrs), rho))


def _tables(rho=2, name="ccsds-k7"):
    from repro.core.trellis import build_acs_tables as ref_tables

    from repro_torch.core import build_acs_tables

    spec, ref_spec = _specs(name)
    return build_acs_tables(spec, rho), ref_tables(ref_spec, rho)


def _random_m(N, F, S, seed):
    """Tile-matrix-like operands: Gaussian scores with some -1e9 entries."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0.0, 20.0, (N, F, S, S)).astype(np.float32)
    m[rng.random(m.shape) < 0.2] = -1.0e9
    return m


# -- associative_scan: jax.lax.associative_scan's pairing tree ------------

@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", range(1, 34))
def test_associative_scan_matches_jax_bit_for_bit(n, reverse):
    """A non-commutative f32 operator (the tropical compose, which rounds
    each sum) tells pairing trees apart (see the next test)."""
    import jax
    import jax.numpy as jnp
    from repro.core.timeparallel import tropical_matmul as ref_mm

    from repro_torch.core.timeparallel import associative_scan, tropical_matmul

    x = np.random.default_rng(n).normal(0.0, 5.0, (n, 2, 4, 4)).astype(np.float32)
    got = associative_scan(tropical_matmul, torch.from_numpy(x), reverse=reverse)
    scan = functools.partial(jax.lax.associative_scan, ref_mm, reverse=reverse)
    want = jax.jit(scan)(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_associative_scan_tree_is_not_a_fold():
    """The operator above does tell trees apart: a sequential left fold
    gives other bits than the tree (held to JAX's above) for most n in
    3-33."""
    from repro_torch.core.timeparallel import associative_scan, tropical_matmul

    differ = 0
    for n in range(3, 34):
        x = torch.from_numpy(
            np.random.default_rng(n).normal(0.0, 5.0, (n, 2, 4, 4)).astype(np.float32))
        fold = [x[0]]
        for i in range(1, n):
            fold.append(tropical_matmul(fold[-1], x[i]))
        differ += not torch.equal(torch.stack(fold), associative_scan(tropical_matmul, x))
    assert differ > 31 // 2


# -- the semiring compose ------------------------------------------------

@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_semiring_matmul_and_identity_match_reference(mm, monkeypatch):
    """Bit for bit, with broadcasting, and whatever the chunk size."""
    import jax.numpy as jnp
    from repro.core.semiring import TROPICAL as REF
    from repro.core.timeparallel import tropical_identity as ref_identity

    from repro_torch.core import semiring
    from repro_torch.core.semiring import TROPICAL
    from repro_torch.core.timeparallel import tropical_identity

    a = _random_m(3, 2, 8, 1)
    b = _random_m(1, 2, 8, 2)
    mm_t, mm_j = {"f32": (torch.float32, jnp.float32),
                  "bf16": (torch.bfloat16, jnp.bfloat16)}[mm]
    want = np.asarray(REF.matmul(jnp.asarray(a), jnp.asarray(b), mm_j))
    for cap in (1, 8 * 8 * 8 * 4 * 2, 2**28):
        monkeypatch.setattr(semiring, "COMPOSE_TEMP_BYTES", cap)
        got = TROPICAL.matmul(torch.from_numpy(a), torch.from_numpy(b), mm_t)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tropical_identity(8, "cpu").numpy(), np.asarray(ref_identity(8)))
    np.testing.assert_array_equal(
        TROPICAL.identity(5, "cpu").numpy(), np.asarray(REF.identity(5)))


# -- formation: plain version and K3 wrapper against XLA and Pallas -------

@pytest.mark.parametrize("F", [3, 5], ids=["F3", "F5"])
@pytest.mark.parametrize("label", ["f32", "bf16-split"])
def test_transfer_matrices_match_reference(label, F):
    """The port's plain formation (``use_kernel=False``) and K3's
    wrapper (its plain version on CPU tensors) against the reference's
    XLA formation and its Pallas K3, bit for bit on integer LLRs.  F=3
    and F=5 are multiples neither of K3's block (2 frames at S=64) nor
    of the reference's (8)."""
    from repro.core.timeparallel import transfer_matrices as ref_tm
    from repro.kernels.ops import viterbi_transfer_matrices as ref_pallas

    from repro_torch.core.kernel_geometry import k3_block_frames
    from repro_torch.core.timeparallel import transfer_matrices

    assert F % k3_block_frames(64)
    tb, rtb = _tables()
    prec, rprec = _precisions(label)
    blocks, rblocks = _blocks(F, 128, seed=F, integer=True)
    want = np.asarray(ref_tm(rblocks, rtb, rprec, 8))
    np.testing.assert_array_equal(
        np.asarray(ref_pallas(rblocks, rtb, rprec, transfer_tile=8)), want)
    for use_kernel in (False, True):
        got = transfer_matrices(blocks, tb, prec, 8, use_kernel=use_kernel)
        assert got.shape == (8, F, 64, 64) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("label", ["f32", "bf16-split"])
def test_transfer_matrices_gaussian_llrs(label):
    from repro.core.timeparallel import transfer_matrices as ref_tm
    from repro.kernels.ops import viterbi_transfer_matrices as ref_pallas

    from repro_torch.core.timeparallel import transfer_matrices

    tb, rtb = _tables()
    prec, rprec = _precisions(label)
    blocks, rblocks = _blocks(3, 256, seed=8)
    want = np.asarray(ref_pallas(rblocks, rtb, rprec, transfer_tile=16))
    np.testing.assert_array_equal(np.asarray(ref_tm(rblocks, rtb, rprec, 16)), want)
    for use_kernel in (False, True):
        got = transfer_matrices(blocks, tb, prec, 16, use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)


# -- scans: prefix entries, suffix to the final state, prefix products ----

@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_prefix_and_suffix_metrics_match_reference(mm):
    import jax.numpy as jnp
    from repro.core.timeparallel import _suffix_to_final as ref_suffix
    from repro.core.timeparallel import prefix_entry_metrics as ref_prefix

    from repro_torch.core.timeparallel import (
        _suffix_to_final, prefix_entry_metrics,
    )

    mm_t, mm_j = {"f32": (torch.float32, jnp.float32),
                  "bf16": (torch.bfloat16, jnp.bfloat16)}[mm]
    for N in (1, 6, 13):
        m = _random_m(N, 3, 64, N)
        lam0 = np.random.default_rng(N).normal(0, 3, (3, 64)).astype(np.float32)
        fs = np.array([0, 17, 63])
        np.testing.assert_array_equal(
            prefix_entry_metrics(torch.from_numpy(m), torch.from_numpy(lam0), mm_t).numpy(),
            np.asarray(ref_prefix(jnp.asarray(m), jnp.asarray(lam0), mm_j)),
        )
        np.testing.assert_array_equal(
            _suffix_to_final(torch.from_numpy(m), torch.from_numpy(fs), mm_t).numpy(),
            np.asarray(ref_suffix(jnp.asarray(m), jnp.asarray(fs), mm_j)),
        )


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "packed"])
def test_transfer_prefix_and_forward_match_reference(pack):
    """``transfer_prefix``, and ``timeparallel_forward`` with and without a
    precomputed prefix: prefix products, final metrics and survivors."""
    import jax.numpy as jnp
    from repro.core.timeparallel import timeparallel_forward as ref_forward
    from repro.core.timeparallel import transfer_prefix as ref_prefix

    from repro_torch.core.timeparallel import timeparallel_forward, transfer_prefix
    from repro_torch.core.viterbi import forward_fused, init_metric

    tb, rtb = _tables()
    blocks, rblocks = _blocks(3, 512, seed=21)
    lam0 = init_metric(3, 64, None, "cpu")
    prefix = transfer_prefix(blocks, tb, transfer_tile=32)
    rprefix = ref_prefix(rblocks, rtb, transfer_tile=32)
    np.testing.assert_array_equal(prefix.numpy(), np.asarray(rprefix))
    want = ref_forward(rblocks, jnp.asarray(lam0.numpy()), rtb,
                       transfer_tile=32, pack_survivors=pack)
    seq = forward_fused(blocks, lam0, tb, pack_survivors=pack)
    for pre in (None, prefix):
        lam, phis = timeparallel_forward(blocks, lam0, tb, transfer_tile=32,
                                         pack_survivors=pack, prefix=pre)
        np.testing.assert_array_equal(lam.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(phis.numpy(), np.asarray(want[1]))
        # the survivors are the sequential scan's
        np.testing.assert_array_equal(phis.numpy(), seq[1].numpy())


# -- decode_time_parallel ---------------------------------------------------

DECODE_CASES = [
    # (code, rho, initial_state, final_state, pack, tile)
    ("ccsds-k7", 2, 0, None, False, 16),
    ("ccsds-k7", 2, None, None, True, 32),
    ("ccsds-k7", 2, 0, 0, True, 8),
    ("ccsds-k7", 2, None, 0, False, 16),
    ("ccsds-k7", 1, 0, None, True, 32),
    ("ccsds-k7", 1, None, 0, False, 16),
    ("ccsds-k7", 3, 0, None, False, 8),
    ("ccsds-k7", 3, None, 0, False, 16),
    ("wifi-11a", 2, 0, 0, True, 16),
    ("lte-tbcc", 2, 0, None, False, 16),
    ("lte-tbcc", 1, None, 0, True, 32),
    ("gsm-cs1", 2, 0, 0, False, 16),
    ("gsm-cs1", 1, None, None, True, 8),
]


@pytest.mark.parametrize("name,rho,init,final,pack,tile", DECODE_CASES)
def test_decode_time_parallel_matches_reference_and_sequential(
        name, rho, init, final, pack, tile):
    import jax.numpy as jnp
    from repro.core.timeparallel import decode_time_parallel as ref_decode

    from repro_torch.core import decode_frames, decode_time_parallel

    spec, ref_spec = _specs(name)
    llrs = _llrs(3, 96 * rho, seed=rho * 7 + (init is None), beta=spec.beta)
    kw = dict(rho=rho, initial_state=init, final_state=final)
    got = decode_time_parallel(llrs, spec, transfer_tile=tile,
                               pack_survivors=pack, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == llrs.shape[:2]
    # the reference's packing is corrupt at rho >= 3 (fault R1): it runs
    # unpacked there, the port refuses packing
    want = ref_decode(jnp.asarray(llrs), ref_spec, transfer_tile=tile,
                      pack_survivors=pack and rho <= 2, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    seq = decode_frames(llrs, spec, pack_survivors=pack, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), seq.numpy())


def test_decode_time_parallel_through_reference_kernels():
    """The reference with its Pallas K3 and K1 (interpret mode) against
    the port's wrappers (plain versions on the CPU)."""
    import jax.numpy as jnp
    from repro.core.timeparallel import decode_time_parallel as ref_decode

    from repro_torch.core import decode_time_parallel

    spec, ref_spec = _specs()
    llrs = _llrs(2, 256, seed=9)
    got = decode_time_parallel(llrs, spec, initial_state=None,
                               transfer_tile=16, device="cpu")
    want = ref_decode(jnp.asarray(llrs), ref_spec, initial_state=None,
                      transfer_tile=16, use_kernel=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_time_parallel_refuses_packing_at_rho3():
    from repro_torch.core import decode_time_parallel

    spec, _ = _specs()
    with pytest.raises(ValueError, match="rho <= 2"):
        decode_time_parallel(_llrs(2, 96, seed=1), spec, rho=3,
                             transfer_tile=8, pack_survivors=True,
                             device="cpu")


def test_integer_ties_break_as_the_reference_breaks_them():
    """On integer-valued noise many paths tie; the time-parallel decode
    then picks its tile-boundary states by first argmax, as the
    reference's does, and the traceback inside a tile may reach another
    state of the same score, so the bits of two tiles need not meet: on
    this input the reference returns, for three of the four frames, a
    path that scores below the sequential decode's (ROADMAP queue 3,
    R5).  The port keeps the reference's semantics and its bits."""
    import jax.numpy as jnp
    from repro.core.timeparallel import decode_time_parallel as ref_decode
    from repro.core.viterbi import decode_frames as ref_frames

    from repro_torch.core import conv_encode_torch, decode_time_parallel
    from repro_torch.core.channel import bpsk

    spec, ref_spec = _specs()
    llrs = _llrs(4, 1024, seed=1, integer=True)
    got = decode_time_parallel(llrs, spec, transfer_tile=32, device="cpu")
    want = np.asarray(ref_decode(jnp.asarray(llrs), ref_spec, transfer_tile=32))
    seq = np.asarray(ref_frames(jnp.asarray(llrs), ref_spec))
    assert (want != seq).any()
    np.testing.assert_array_equal(got.numpy(), want)

    def score(bits):  # what an ML decoder maximises
        symbols = bpsk(conv_encode_torch(torch.as_tensor(bits), spec))
        return (torch.from_numpy(llrs).double() * symbols.double()).sum(dim=(1, 2))

    assert (score(got) <= score(seq)).all()


# -- the front door ----------------------------------------------------------

def _dispatches(fn):
    from repro_torch.obs.metrics import MetricsRegistry, set_default_registry

    reg = MetricsRegistry()
    old = set_default_registry(reg)
    try:
        out = fn()
    finally:
        set_default_registry(old)
    return out, {labels["path"]: n for labels, n
                 in reg.counter("decoder_dispatch_total").series()}


@pytest.mark.parametrize("use_kernel", [True, False], ids=["kernels", "plain"])
def test_decode_batch_time_parallel_matches_reference(use_kernel):
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    from repro_torch.core import ViterbiDecoder

    spec, ref_spec = _specs()
    llrs = _llrs(3, 515, seed=30)  # odd length: zero-LLR padded to rho
    dec = ViterbiDecoder(spec, use_kernel=use_kernel, transfer_tile=16,
                         device="cpu")
    got, paths = _dispatches(lambda: dec.decode_batch(llrs, time_parallel=True))
    assert paths == {"time_parallel": 1} and got.shape == (3, 515)
    ref = RefDecoder(ref_spec, time_parallel=True, transfer_tile=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.decode_batch(llrs)))
    seq, paths = _dispatches(lambda: dec.decode_batch(llrs))
    assert paths == {"batch": 1}  # auto never engages on the CPU
    np.testing.assert_array_equal(got.numpy(), seq.numpy())
    on = ViterbiDecoder(spec, time_parallel=True, transfer_tile=16, device="cpu")
    _, paths = _dispatches(lambda: on.decode_batch(llrs[:, :512], final_state=0))
    assert paths == {"time_parallel": 1}


def test_decode_stream_tiled_time_parallel_matches_reference():
    """Large windows through the time-parallel decode: an explicit
    ``time_parallel=True`` beats the one-pass plan, as in the reference."""
    import jax.numpy as jnp
    from repro.core.decoder import ViterbiDecoder as RefDecoder
    from repro.core.viterbi import tiled_decode_stream as ref_tiled

    from repro_torch.core import TiledDecoderConfig, ViterbiDecoder, tiled_decode_stream

    spec, ref_spec = _specs()
    stream = _llrs(1, 1500, seed=4)[0]
    cfg = TiledDecoderConfig(frame_len=256, overlap=64, rho=2)
    want = np.asarray(ref_tiled(jnp.asarray(stream), ref_spec, cfg,
                                time_parallel=True, transfer_tile=16))
    got = tiled_decode_stream(stream, spec, cfg, time_parallel=True,
                              transfer_tile=16, one_pass=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tiled_decode_stream(stream, spec, cfg, device="cpu").numpy())
    dec = ViterbiDecoder(spec, time_parallel=True, transfer_tile=16, device="cpu")
    ref = RefDecoder(ref_spec, time_parallel=True, transfer_tile=16, use_kernel=True)
    got, paths = _dispatches(lambda: dec.decode_stream_tiled(stream, cfg))
    assert paths == {"tiled": 1}
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.decode_stream_tiled(jnp.asarray(stream), cfg)))


# -- LOGPROB: the BCJR's formation and scans -------------------------------

def _close_reachable(got, want):
    got, want = np.asarray(got), np.asarray(want)
    reach = want > -1e8
    np.testing.assert_array_equal(got > -1e8, reach)
    np.testing.assert_allclose(got[reach], want[reach], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[~reach], want[~reach])


@pytest.mark.parametrize("label", ["f32", "bf16-split"])
def test_transfer_matrices_logprob_match_reference(label):
    """The plain formation and K3's wrapper at LOGPROB against the
    reference's XLA formation and its Pallas K3, on half-scaled
    Gaussian scores, at a tile of 16 steps and at one step a tile."""
    from repro.core.semiring import LOGPROB as REF_LOGPROB
    from repro.core.timeparallel import transfer_matrices as ref_tm
    from repro.kernels.ops import viterbi_transfer_matrices as ref_pallas

    from repro_torch.core.semiring import LOGPROB
    from repro_torch.core.timeparallel import transfer_matrices

    tb, rtb = _tables()
    prec, rprec = _precisions(label)
    blocks, rblocks = _blocks(3, 64, seed=31)
    for tile in (16, 1):
        want = np.asarray(ref_tm(rblocks * 0.5, rtb, rprec, tile,
                                 semiring=REF_LOGPROB))
        _close_reachable(ref_pallas(rblocks * 0.5, rtb, rprec, transfer_tile=tile,
                                    semiring="logprob"), want)
        for use_kernel in (False, True):
            got = transfer_matrices(blocks * 0.5, tb, prec, tile,
                                    use_kernel=use_kernel, semiring=LOGPROB)
            assert got.shape == (32 // tile, 3, 64, 64)
            _close_reachable(got.numpy(), want)


def test_logprob_scans_match_reference():
    """``associative_scan`` of the LOGPROB compose both ways,
    ``prefix_entry_metrics`` and ``transfer_prefix`` at LOGPROB."""
    import jax
    import jax.numpy as jnp
    from repro.core.semiring import LOGPROB as REF_LOGPROB
    from repro.core.timeparallel import prefix_entry_metrics as ref_entry
    from repro.core.timeparallel import transfer_prefix as ref_prefix

    from repro_torch.core.semiring import LOGPROB
    from repro_torch.core.timeparallel import (
        associative_scan, prefix_entry_metrics, transfer_prefix,
    )

    m = _random_m(7, 2, 64, 3)
    lam0 = np.random.default_rng(3).normal(0, 3, (2, 64)).astype(np.float32)
    for reverse in (False, True):
        got = associative_scan(LOGPROB.matmul, torch.from_numpy(m), reverse=reverse)
        want = jax.lax.associative_scan(REF_LOGPROB.matmul, jnp.asarray(m),
                                        reverse=reverse)
        _close_reachable(got.numpy(), want)
    _close_reachable(
        prefix_entry_metrics(torch.from_numpy(m), torch.from_numpy(lam0),
                             semiring=LOGPROB).numpy(),
        ref_entry(jnp.asarray(m), jnp.asarray(lam0), semiring=REF_LOGPROB),
    )
    tb, rtb = _tables()
    blocks, rblocks = _blocks(2, 128, seed=32)
    _close_reachable(
        transfer_prefix(blocks * 0.5, tb, transfer_tile=8, semiring=LOGPROB).numpy(),
        ref_prefix(rblocks * 0.5, rtb, transfer_tile=8, semiring=REF_LOGPROB),
    )


@pytest.mark.parametrize("n_frames", [1, 15, 16, 17, 64])
def test_time_parallel_plan_at_the_reference_budget(n_frames):
    """Given the reference's accelerator budget of 1,024 rows, the port's
    plan picks what the reference's picks, for F x S on both sides of
    it; on the card the port's own budget is larger (CUDA_ROW_BUDGET)."""
    from repro.core.backend import _ACCEL_ROW_BUDGET
    from repro.core.kernel_geometry import time_parallel_plan as ref_plan

    from repro_torch.core.backend import CUDA_ROW_BUDGET
    from repro_torch.core.kernel_geometry import time_parallel_plan

    assert _ACCEL_ROW_BUDGET == 1024 < CUDA_ROW_BUDGET
    for t_steps in (64, 4096, 32768):
        for tp in (None, True, False):
            got = time_parallel_plan(n_frames, t_steps, 64, tp, None, 1024)
            want = ref_plan(n_frames, t_steps, 64, tp, None, 1024)
            assert got == want
    picked = time_parallel_plan(n_frames, 32768, 64, None, None, 1024)
    assert (picked is not None) == (n_frames * 64 <= 1024)
