"""The soft-output slice: ``repro_torch.core.soft``, the LOGPROB semiring,
the reverse tables and ``ViterbiDecoder.decode_soft`` against the
reference's ``repro.core.soft`` and ``decode_soft``, through its XLA
path (``use_kernel=False``) and its interpret-mode Pallas kernels
(``use_kernel=True``), on the same numpy-made LLRs.

Tolerances (the reference's own ``tests/test_soft.py`` uses atol 1e-4):
  * BCJR LLRs (``bcjr_llrs``, ``bcjr_circular_llrs``,
    ``decode_soft("llr")``): atol 1e-4 where |LLR| < 1e8; the bits an
    end pin forces saturate near +-1e9 on both sides, with equal signs;
  * ``decode_soft("bits")`` is exactly ``llr < 0`` of the port's LLRs,
    and equals the reference's bits wherever |LLR| > 1e-3;
  * list decoding: bits exactly equal, metrics atol 1e-4; at L=1 the
    bits equal the hard decode's exactly (integer LLRs, full of ties);
  * ``forward_fused`` at LOGPROB: metrics atol 1e-4, survivors exactly
    equal wherever the top two potentials differ by more than 1e-3.
"""
import numpy as np
import pytest
import torch

ATOL = 1e-4
SAT = 1e8  # |LLR| above this: a bit an end pin forces
K5 = (5, (0o23, 0o35))  # the small code of the reference's soft tests


def _specs(code):
    """(port spec, reference spec) of a registry name or a (k, polys)."""
    from repro.core.trellis import CodeSpec as RefSpec

    from repro_torch.codes import get_code
    from repro_torch.core import CodeSpec

    spec = get_code(code).spec if isinstance(code, str) else CodeSpec(*code)
    return spec, RefSpec(k=spec.k, polys=spec.polys)


def _llrs(spec, F, n, seed, ebn0_db=2.0, tail="flush", integer=False):
    """(F, n, beta) float32 LLRs of random codewords through AWGN, made
    with numpy (positive = bit 0).  ``tail``: "flush" (the last k-1
    bits are zero, so the encoder ends in state 0), "bite" (tail-biting)
    or "open".  ``integer`` rounds them to integers in [-8, 8]."""
    from repro_torch.core import conv_encode
    from repro_torch.core.channel import awgn_sigma

    rng = np.random.default_rng(seed)
    k = spec.k
    coded = []
    for _ in range(F):
        bits = rng.integers(0, 2, n)
        if tail == "flush":
            bits[n - (k - 1):] = 0
            coded.append(conv_encode(bits, spec))
        elif tail == "bite":  # pre-fill the register with the last k-1 bits
            coded.append(conv_encode(np.concatenate([bits[n - (k - 1):], bits]),
                                     spec)[k - 1:])
        else:
            coded.append(conv_encode(bits, spec))
    sigma = awgn_sigma(ebn0_db, spec.rate)
    y = (1.0 - 2.0 * np.stack(coded)) + sigma * rng.normal(size=(F, n, spec.beta))
    out = (2.0 * y / sigma**2).astype(np.float32)
    return np.clip(np.round(out), -8, 8).astype(np.float32) if integer else out


def _close_llrs(got, want):
    """atol 1e-4 on |LLR| < 1e8; saturated entries saturated on both
    sides with equal signs."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    sat = np.abs(want) > SAT
    np.testing.assert_array_equal(np.abs(got) > SAT, sat)
    np.testing.assert_array_equal(np.sign(got[sat]), np.sign(want[sat]))
    np.testing.assert_allclose(got[~sat], want[~sat], atol=ATOL, rtol=0)


def _ref_decoder(name, use_kernel, rho=2):
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    return RefDecoder.from_standard(name, rho=rho, use_kernel=use_kernel)


def _port_decoder(name, use_kernel=True, **kw):
    from repro_torch.core import ViterbiDecoder

    return ViterbiDecoder.from_standard(name, use_kernel=use_kernel,
                                        device="cpu", **kw)


# -- the LOGPROB semiring ------------------------------------------------

def test_logprob_sum_is_the_reference_form():
    """m + log(sum(exp(x - m))) with m the max, as the reference writes
    it: -1e9 entries add exactly nothing, an all-(-1e9) row stays at
    -1e9 + log(R) rounded, and nothing turns into a NaN."""
    import jax.numpy as jnp
    from repro.core.semiring import LOGPROB as REF

    from repro_torch.core.semiring import LOGPROB, NEG

    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 30.0, (64, 4)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = NEG
    x[0] = NEG  # nothing reachable
    x[1] = [NEG, 5.0, NEG, NEG]  # one reachable entry
    got = LOGPROB.sum(torch.from_numpy(x)).numpy()
    want = np.asarray(REF.sum(jnp.asarray(x)))
    assert np.isfinite(got).all()
    assert got[1] == 5.0 and got[0] == want[0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_semiring_names():
    from repro_torch.core.semiring import (
        LOGPROB, TROPICAL, Semiring, check_semiring, get_semiring,
    )

    assert get_semiring("logprob") is LOGPROB
    assert get_semiring("tropical") is TROPICAL
    assert Semiring("logprob") == LOGPROB
    for bad in (lambda: get_semiring("maxplus"),
                lambda: Semiring("maxplus"),
                lambda: check_semiring("LOGPROB")):
        with pytest.raises(ValueError, match="unknown semiring"):
            bad()


@pytest.mark.parametrize("name", ["tropical", "logprob"])
def test_semiring_zero_one_prod_equal_reference(name):
    """``zero``, ``one`` and ``prod`` against the reference's, on the cases
    of its ``test_zero_one_elements``: zero vanishes under sum, one is
    neutral under prod."""
    import jax.numpy as jnp
    from repro.core.semiring import get_semiring as ref_get

    from repro_torch.core.semiring import get_semiring

    sr, ref = get_semiring(name), ref_get(name)
    assert sr.zero == float(ref.zero) and sr.one == ref.one == 0.0
    x = np.asarray([1.5, -2.0], np.float32)
    got = sr.sum(torch.tensor([sr.zero, 3.0]))
    want = np.asarray(ref.sum(jnp.asarray([ref.zero, 3.0])))
    assert float(got) == pytest.approx(3.0, abs=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(sr.prod(torch.from_numpy(x), sr.one).numpy(), x)
    y = np.asarray([0.25, 4.0], np.float32)
    np.testing.assert_array_equal(
        sr.prod(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(ref.prod(jnp.asarray(x), jnp.asarray(y))))


@pytest.mark.parametrize("mm", ["f32", "bf16"])
def test_logprob_matmul_and_identity_match_reference(mm, monkeypatch):
    """The LOGPROB compose at atol 1e-4 over reachable entries, equal on
    unreachable ones, whatever the chunk size; the identity exactly."""
    import jax.numpy as jnp
    from repro.core.semiring import LOGPROB as REF

    from repro_torch.core import semiring
    from repro_torch.core.semiring import LOGPROB

    rng = np.random.default_rng(1)
    a = rng.normal(0.0, 20.0, (3, 2, 8, 8)).astype(np.float32)
    b = rng.normal(0.0, 20.0, (1, 2, 8, 8)).astype(np.float32)
    a[rng.random(a.shape) < 0.4] = -1e9
    b[rng.random(b.shape) < 0.4] = -1e9
    a[0, 0, 0] = -1e9  # a row of nothing
    mm_t, mm_j = {"f32": (torch.float32, jnp.float32),
                  "bf16": (torch.bfloat16, jnp.bfloat16)}[mm]
    want = np.asarray(REF.matmul(jnp.asarray(a), jnp.asarray(b), mm_j))
    reach = want > -1e8
    assert (~reach).any() and reach.any()
    for cap in (1, 8 * 8 * 8 * 4 * 2, 2**28):
        monkeypatch.setattr(semiring, "COMPOSE_TEMP_BYTES", cap)
        got = LOGPROB.matmul(torch.from_numpy(a), torch.from_numpy(b), mm_t).numpy()
        np.testing.assert_array_equal(got > -1e8, reach)
        np.testing.assert_allclose(got[reach], want[reach], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(got[~reach], want[~reach])
    np.testing.assert_array_equal(
        LOGPROB.identity(6, "cpu").numpy(), np.asarray(REF.identity(6)))


# -- the reverse tables ----------------------------------------------------

REV_FIELDS = ("theta_rev", "succ_onehot", "succ_state")


@pytest.mark.parametrize("rho", [1, 2])
@pytest.mark.parametrize("code", ["ccsds-k7", "lte-tbcc", K5],
                         ids=["k7", "k7-beta3", "k5"])
def test_reverse_tables_equal_reference(code, rho):
    from repro.core.trellis import build_reverse_tables as ref_build

    from repro_torch.core.trellis import build_reverse_tables

    spec, ref_spec = _specs(code)
    got, want = build_reverse_tables(spec, rho), ref_build(ref_spec, rho)
    for name in REV_FIELDS + ("fused_w",):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got.n_states, got.n_slots, got.llr_block) == (
        want.n_states, want.n_slots, want.llr_block)


def test_reverse_tables_carried_across():
    """``reverse_tables_from_numpy`` takes the reference's arrays as they
    are and refuses missing, misshapen or inconsistent ones."""
    from repro.core.trellis import build_reverse_tables as ref_build

    from repro_torch.core.trellis import (
        build_reverse_tables, reverse_tables_from_numpy,
    )

    spec, ref_spec = _specs("ccsds-k7")
    ref = ref_build(ref_spec, 2)
    arrays = {name: np.asarray(getattr(ref, name)) for name in REV_FIELDS}
    arrays["fused_w"] = np.asarray(ref.fused_w)
    got = reverse_tables_from_numpy(spec, 2, arrays)
    np.testing.assert_array_equal(got.fused_w, build_reverse_tables(spec, 2).fused_w)
    with pytest.raises(ValueError, match="missing"):
        reverse_tables_from_numpy(spec, 2, {"theta_rev": ref.theta_rev})
    with pytest.raises(ValueError, match="shape"):
        reverse_tables_from_numpy(spec, 1, arrays)
    with pytest.raises(ValueError, match="fused_w"):
        reverse_tables_from_numpy(
            spec, 2, dict(arrays, fused_w=np.zeros_like(ref.fused_w)))


# -- forward_fused at LOGPROB (K1-LOGPROB's path) ----------------------------

def _potential_gaps(blocks, lam0, tables):
    """Per (t, f, j): the gap between the two largest LOGPROB potentials
    of the plain forward, from the port's own per-step metrics."""
    from repro_torch.core.soft import _alpha_scan
    from repro_torch.core.viterbi import AcsPrecision, fused_potentials

    alphas = _alpha_scan(blocks, lam0, tables, AcsPrecision())
    prev = torch.cat([lam0[None], alphas[:-1]], dim=0)
    w = torch.as_tensor(tables.fused_w)
    B, S, R = tables.llr_block, tables.n_states, tables.n_slots
    T, F = blocks.shape[:2]
    pot = fused_potentials(
        blocks.reshape(T * F, -1), prev.reshape(T * F, S), w, w[:B], w[B:],
        AcsPrecision(),
    ).view(T, F, S, R)
    top = pot.topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).numpy()


@pytest.mark.parametrize("code", ["ccsds-k7", K5], ids=["k7", "k5"])
def test_forward_fused_logprob_matches_reference(code):
    """``forward_fused(semiring=LOGPROB)`` through K1's wrapper (its
    plain version here) and through the plain scan, against the
    reference's interpret-mode K1 and its XLA scan."""
    import jax.numpy as jnp
    from repro.core.semiring import LOGPROB as REF_LOGPROB
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import forward_fused as ref_forward

    from repro_torch.core import build_acs_tables
    from repro_torch.core.semiring import LOGPROB
    from repro_torch.core.viterbi import blocks_from_llrs, forward_fused, init_metric

    spec, ref_spec = _specs(code)
    llrs = _llrs(spec, 3, 128, seed=4) * 0.5
    blocks = blocks_from_llrs(torch.from_numpy(llrs), 2).contiguous()
    lam0 = init_metric(3, spec.n_states, 0, device="cpu")
    tb, rtb = build_acs_tables(spec, 2), ref_tables(ref_spec, 2)
    gaps = _potential_gaps(blocks, lam0, tb)
    decided = gaps > 1e-3
    for ref_kernel in (True, False):
        lam_r, phi_r = ref_forward(
            jnp.asarray(blocks.numpy()), jnp.asarray(lam0.numpy()), rtb,
            use_kernel=ref_kernel, semiring=REF_LOGPROB,
        )
        for use_kernel in (True, False):
            lam_p, phi_p = forward_fused(blocks, lam0, tb, use_kernel=use_kernel,
                                         semiring=LOGPROB)
            np.testing.assert_allclose(lam_p.numpy(), np.asarray(lam_r),
                                       atol=ATOL, rtol=0)
            np.testing.assert_array_equal(phi_p.numpy()[decided],
                                          np.asarray(phi_r)[decided])
    assert decided.mean() > 0.9


# -- BCJR ------------------------------------------------------------------

@pytest.mark.parametrize("code,init,final", [
    ("ccsds-k7", 0, None),
    ("ccsds-k7", 0, 0),
    (K5, 0, None),
    (K5, None, None),
    (K5, 0, 0),
], ids=["k7-open", "k7-pinned", "k5-open", "k5-uniform", "k5-pinned"])
def test_bcjr_llrs_match_reference(code, init, final):
    """Both packages' kernel and plain formations, crossed."""
    import jax.numpy as jnp
    from repro.core.soft import bcjr_llrs as ref_bcjr

    from repro_torch.core.soft import bcjr_llrs

    spec, ref_spec = _specs(code)
    llrs = _llrs(spec, 3, 128, seed=5, tail="flush")
    for ref_kernel in (False, True):
        want = ref_bcjr(jnp.asarray(llrs), ref_spec, initial_state=init,
                        final_state=final, use_kernel=ref_kernel)
        for use_kernel in (False, True):
            got = bcjr_llrs(torch.from_numpy(llrs), spec, initial_state=init,
                            final_state=final, use_kernel=use_kernel,
                            device="cpu")
            _close_llrs(got.numpy(), want)
    if final is not None:  # the k-1 flush bits of each frame are forced
        assert (np.abs(got.numpy()) > SAT).sum() == 3 * (spec.k - 1)


def test_bcjr_llrs_fully_pinned_stay_finite():
    """Start and end pinned on a short frame: the -1e9 of every
    unreachable state meets exp() as exactly 0, so no NaN appears in
    the boundary joints or the LLRs, at any transfer tile."""
    import jax.numpy as jnp
    from repro.core.soft import bcjr_llrs as ref_bcjr

    from repro_torch.core.soft import _bcjr_joints, bcjr_llrs
    from repro_torch.core.trellis import build_acs_tables, build_reverse_tables
    from repro_torch.core.viterbi import AcsPrecision, blocks_from_llrs, init_metric

    spec, ref_spec = _specs("ccsds-k7")
    llrs = _llrs(spec, 2, 16, seed=6, tail="flush")
    blocks = blocks_from_llrs(torch.from_numpy(llrs), 2) * 0.5
    lam0 = init_metric(2, 64, 0, device="cpu")
    for tile in (1, 2, 8):
        joint = _bcjr_joints(
            blocks, lam0, lam0.clone(), build_acs_tables(spec, 2),
            build_reverse_tables(spec, 2), AcsPrecision(), tile, True,
        )
        assert torch.isfinite(joint).all()
        got = bcjr_llrs(torch.from_numpy(llrs), spec, final_state=0,
                        transfer_tile=tile, device="cpu")
        want = ref_bcjr(jnp.asarray(llrs), ref_spec, final_state=0,
                        transfer_tile=tile)
        _close_llrs(got.numpy(), want)


@pytest.mark.parametrize("code,n,rho", [
    ("lte-tbcc", 24, 2),
    ("lte-tbcc", 25, 1),
    (K5, 20, 2),
], ids=["tbcc-even", "tbcc-odd-rho1", "k5"])
def test_bcjr_circular_matches_reference(code, n, rho):
    import jax.numpy as jnp
    from repro.core.soft import bcjr_circular_llrs as ref_circ
    from repro.core.trellis import build_acs_tables as ref_tables

    from repro_torch.core import build_acs_tables
    from repro_torch.core.soft import bcjr_circular_llrs

    spec, ref_spec = _specs(code)
    llrs = _llrs(spec, 3, n, seed=n, tail="bite")
    for ref_kernel in (False, True):
        want = ref_circ(jnp.asarray(llrs), ref_tables(ref_spec, rho),
                        use_kernel=ref_kernel)
        for use_kernel in (False, True):
            got = bcjr_circular_llrs(torch.from_numpy(llrs),
                                     build_acs_tables(spec, rho),
                                     use_kernel=use_kernel, device="cpu")
            _close_llrs(got.numpy(), want)


def test_circular_joints_identity_and_no_nan():
    """The circular path's closing identity is 0 / -1e9 on the input's
    device, and a one-step frame (every boundary pinned to itself)
    gives finite joints equal to the reference's."""
    import jax.numpy as jnp
    from repro.core.soft import _bcjr_circular_joints as ref_joints
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core import build_acs_tables
    from repro_torch.core.semiring import LOGPROB, NEG
    from repro_torch.core.soft import _bcjr_circular_joints
    from repro_torch.core.viterbi import AcsPrecision, blocks_from_llrs

    ident = LOGPROB.identity(64, "cpu")
    assert ident.device.type == "cpu"
    assert torch.equal(ident.diagonal(), torch.zeros(64))
    assert (ident[~torch.eye(64, dtype=torch.bool)] == NEG).all()
    spec, ref_spec = _specs("lte-tbcc")
    for n in (2, 12):
        # n=2 is shorter than the register: no tail-biting codeword, noise
        llrs = _llrs(spec, 2, n, seed=n, tail="bite" if n >= spec.k else "open")
        blocks = blocks_from_llrs(torch.from_numpy(llrs), 2) * 0.5
        got = _bcjr_circular_joints(blocks, build_acs_tables(spec, 2),
                                    AcsPrecision(), True)
        want = np.asarray(ref_joints(jnp.asarray(blocks.numpy()),
                                     ref_tables(ref_spec, 2), RefPrecision(), True))
        assert torch.isfinite(got).all()
        reach = want > -1e8
        np.testing.assert_array_equal(got.numpy() > -1e8, reach)
        np.testing.assert_allclose(got.numpy()[reach], want[reach], atol=ATOL, rtol=0)


# -- list-Viterbi --------------------------------------------------------------

def test_top_k_breaks_ties_to_the_lower_index():
    """``_top_k`` against ``jax.lax.top_k`` on integer rows full of ties."""
    import jax

    from repro_torch.core.soft import _top_k

    x = np.random.default_rng(7).integers(-3, 4, (200, 16)).astype(np.float32)
    x[0] = 1.0  # all equal
    want_v, want_i = jax.lax.top_k(x, 4)
    got_v, got_i = _top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i[0].numpy(), [0, 1, 2, 3])


@pytest.mark.parametrize("code", ["ccsds-k7", K5], ids=["k7", "k5"])
def test_list_l1_is_the_hard_decode_on_integer_ties(code):
    """On integer LLRs potentials tie all the time; the stable top-k
    keeps the first slot as the hard decode's argmax does, so the L=1
    list decode gives ``decode_batch``'s bits (sequential path) and the
    reference's, and the candidate codes of L=4 equal the reference's."""
    import jax.numpy as jnp
    from repro.core.soft import list_forward as ref_list_forward
    from repro.core.soft import init_list_metric as ref_init
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import decode_frames as ref_decode_frames
    from repro.core.viterbi import init_metric as ref_init_metric

    from repro_torch.core import ViterbiDecoder, build_acs_tables
    from repro_torch.core.soft import init_list_metric, list_decode, list_forward
    from repro_torch.core.viterbi import blocks_from_llrs, init_metric

    spec, ref_spec = _specs(code)
    llrs = _llrs(spec, 4, 96, seed=8, ebn0_db=0.0, integer=True)
    dec = ViterbiDecoder(spec, device="cpu")
    hard = dec.decode_batch(llrs, time_parallel=False).numpy()
    np.testing.assert_array_equal(
        hard, np.asarray(ref_decode_frames(jnp.asarray(llrs), ref_spec)))
    bits, met = list_decode(torch.from_numpy(llrs), spec, n_list=1, device="cpu")
    np.testing.assert_array_equal(bits[:, 0].numpy(), hard)
    lbits, _ = dec.decode_soft(llrs, output="list", n_list=1)
    np.testing.assert_array_equal(lbits[:, 0].numpy(), hard)

    blocks = blocks_from_llrs(torch.from_numpy(llrs), 2)
    lam0 = init_list_metric(init_metric(4, spec.n_states, 0, device="cpu"), 4)
    lam, phis = list_forward(blocks, lam0, build_acs_tables(spec, 2), n_list=4)
    rlam, rphis = ref_list_forward(
        jnp.asarray(blocks.numpy()),
        ref_init(ref_init_metric(4, spec.n_states, 0), 4),
        ref_tables(ref_spec, 2), n_list=4,
    )
    np.testing.assert_array_equal(phis.numpy(), np.asarray(rphis))
    np.testing.assert_array_equal(lam.numpy(), np.asarray(rlam))
    # ties do occur: equal metrics at adjacent ranks, which a sort that
    # is not stable would be free to order otherwise
    assert (lam[..., :-1] == lam[..., 1:]).any()


@pytest.mark.parametrize("code,init,final", [
    ("ccsds-k7", 0, None),
    ("ccsds-k7", 0, 0),
    (K5, None, None),
], ids=["k7-open", "k7-pinned", "k5-uniform"])
def test_list_decode_matches_reference(code, init, final):
    import jax.numpy as jnp
    from repro.core.soft import list_decode as ref_list

    from repro_torch.core.soft import list_decode

    spec, ref_spec = _specs(code)
    llrs = _llrs(spec, 3, 64, seed=9, ebn0_db=1.0)
    rb, rm = ref_list(jnp.asarray(llrs), ref_spec, n_list=5,
                      initial_state=init, final_state=final)
    gb, gm = list_decode(torch.from_numpy(llrs), spec, n_list=5,
                         initial_state=init, final_state=final, device="cpu")
    assert gb.dtype == torch.int32 and gb.shape == (3, 5, 64)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_list", [1, 4])
@pytest.mark.parametrize("n,rho", [(48, 2), (47, 1)], ids=["even", "odd-rho1"])
def test_wava_list_decode_matches_reference(n, rho, n_list):
    """Bits exactly, metrics at atol 1e-4, convergence flags exactly; at
    L=1 the bits are the reference's hard tail-biting decode (WAVA)."""
    import jax.numpy as jnp
    from repro.core.soft import wava_list_decode as ref_wava_list
    from repro.core.trellis import build_acs_tables as ref_tables

    from repro_torch.core import build_acs_tables
    from repro_torch.core.soft import wava_list_decode

    spec, ref_spec = _specs("lte-tbcc")
    llrs = _llrs(spec, 4, n, seed=n + n_list, ebn0_db=1.0, tail="bite")
    rb, rm, rc = ref_wava_list(jnp.asarray(llrs), ref_tables(ref_spec, rho),
                               n_list=n_list)
    gb, gm, gc = wava_list_decode(torch.from_numpy(llrs),
                                  build_acs_tables(spec, rho), n_list=n_list,
                                  device="cpu")
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    if n_list == 1:
        ref_dec = _ref_decoder("lte-tbcc", False, rho=rho)
        want, conv = ref_dec.decode_tailbiting(jnp.asarray(llrs))
        np.testing.assert_array_equal(gb[:, 0].numpy(), np.asarray(want))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(conv))


def test_init_list_metric_follows_its_input():
    from repro_torch.core.soft import init_list_metric

    lam0 = torch.randn(3, 8)
    lam = init_list_metric(lam0, 4)
    assert lam.device == lam0.device and lam.shape == (3, 8, 4)
    assert torch.equal(lam[:, :, 0], lam0) and (lam[:, :, 1:] == -1e9).all()


# -- the front door --------------------------------------------------------------

SOFT_CASES = [
    ("ccsds-k7", 64, dict()),
    ("ccsds-k7", 64, dict(final_state=0)),
    ("ccsds-k7", 63, dict()),  # odd length: zero-LLR padded
    ("lte-tbcc", 40, dict()),
    ("lte-tbcc", 41, dict()),  # odd tail-biting length: rho=1 tables
]
SOFT_IDS = ["k7-open", "k7-pinned", "k7-odd", "tbcc-even", "tbcc-odd"]


@pytest.mark.parametrize("name,n,kw", SOFT_CASES, ids=SOFT_IDS)
def test_decode_soft_llr_and_bits_match_reference(name, n, kw):
    import jax.numpy as jnp

    tail = "bite" if name == "lte-tbcc" else "flush"
    spec, _ = _specs(name)
    llrs = _llrs(spec, 3, n, seed=n, ebn0_db=1.0, tail=tail)
    got = {uk: _port_decoder(name, uk).decode_soft(llrs, **kw).numpy()
           for uk in (True, False)}
    for ref_kernel in (False, True):
        want = _ref_decoder(name, ref_kernel).decode_soft(jnp.asarray(llrs), **kw)
        for out in got.values():
            assert out.shape == (3, n)
            _close_llrs(out, want)
    bits = _port_decoder(name).decode_soft(llrs, output="bits", **kw)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), (got[True] < 0).astype(np.int32))
    ref_bits = np.asarray(_ref_decoder(name, False).decode_soft(
        jnp.asarray(llrs), output="bits", **kw))
    clear = np.abs(got[True]) > 1e-3
    np.testing.assert_array_equal(bits.numpy()[clear], ref_bits[clear])


@pytest.mark.parametrize("name,n,kw", SOFT_CASES, ids=SOFT_IDS)
def test_decode_soft_list_matches_reference(name, n, kw):
    import jax.numpy as jnp

    tail = "bite" if name == "lte-tbcc" else "flush"
    spec, _ = _specs(name)
    llrs = _llrs(spec, 3, n, seed=n + 1, ebn0_db=1.0, tail=tail)
    gb, gm = _port_decoder(name).decode_soft(llrs, output="list", n_list=3, **kw)
    rb, rm = _ref_decoder(name, False).decode_soft(
        jnp.asarray(llrs), output="list", n_list=3, **kw)
    assert gb.shape == (3, 3, n) and gm.shape == (3, 3)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_allclose(gm.numpy(), np.asarray(rm), atol=ATOL, rtol=0)


def test_decode_soft_refuses_what_it_cannot_do():
    from repro_torch.core import AcsPrecision
    from repro_torch.core.validate import InvalidInputError, MetricOverflowError

    dec = _port_decoder("ccsds-k7")
    with pytest.raises(ValueError, match="output"):
        dec.decode_soft(torch.zeros(1, 4, 2), output="posterior")
    with pytest.raises(ValueError, match="final_state requires"):
        dec.decode_soft(torch.zeros(1, 5, 2), final_state=0)
    # punctured serial input is depunctured now; input that is neither the
    # serial stream nor (F, n, beta) still raises
    with pytest.raises(InvalidInputError, match="decode_soft expects"):
        _port_decoder("wifi-11a-r34").decode_soft(torch.zeros(1, 8, 3))
    loose = _port_decoder(
        "ccsds-k7", precision=AcsPrecision(carry_dtype=torch.bfloat16, renorm=False))
    with pytest.raises(MetricOverflowError, match="enable renorm"):
        loose.decode_soft(torch.full((1, 64, 2), 1e37))


def test_decode_soft_dispatch_and_kernel_route(monkeypatch):
    """decode_soft counts "soft" / "soft_list" dispatches, and the BCJR
    paths ask K3's wrapper for LOGPROB matrices (one call a decode)."""
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.obs import MetricsRegistry, set_default_registry

    calls = []
    real = kernel_ops.viterbi_transfer_matrices

    def spy(*args, **kw):
        calls.append((kw["semiring"], kw["transfer_tile"]))
        return real(*args, **kw)

    monkeypatch.setattr(kernel_ops, "viterbi_transfer_matrices", spy)
    reg = MetricsRegistry()
    old = set_default_registry(reg)
    try:
        _port_decoder("ccsds-k7").decode_soft(torch.zeros(2, 32, 2))
        _port_decoder("ccsds-k7").decode_soft(torch.zeros(2, 32, 2), output="list")
        _port_decoder("lte-tbcc").decode_soft(torch.zeros(2, 32, 3), output="bits")
    finally:
        set_default_registry(old)
    paths = {labels["path"]: int(n) for labels, n
             in reg.counter("decoder_dispatch_total").series()}
    assert paths == {"soft": 2, "soft_list": 1}
    assert [c[0] for c in calls] == ["logprob", "logprob"] and calls[1][1] == 1


def test_soft_entry_points_default_to_the_card():
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.soft import (
        bcjr_circular_llrs, bcjr_llrs, list_decode, wava_list_decode,
    )

    llrs = torch.zeros(1, 8, 2)
    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    calls = (
        lambda d: bcjr_llrs(llrs, CODE_K7_CCSDS, device=d),
        lambda d: bcjr_circular_llrs(llrs, tb, device=d),
        lambda d: list_decode(llrs, CODE_K7_CCSDS, device=d),
        lambda d: wava_list_decode(llrs, tb, device=d),
    )
    for call in calls:
        if torch.cuda.is_available():
            assert call(None)[0].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(None)
        assert call("cpu")[0].device.type == "cpu"


# -- K6: the within-tile sweeps and the LLR combine -------------------------

K6_CASES = [
    ("ccsds-k7", 1, 1, 5, 3),
    ("ccsds-k7", 1, 8, 3, 3),
    ("ccsds-k7", 1, 256, 2, 3),
    ("ccsds-k7", 2, 1, 5, 3),
    ("ccsds-k7", 2, 8, 3, 3),
    ("ccsds-k7", 2, 256, 2, 3),
    ("lte-tbcc", 2, 8, 3, 3),  # beta = 3
    ("ccsds-k7", 2, 8, 1, 1),  # one row: a block of four rows left three short
]
K6_IDS = ["k7-rho1-tt1", "k7-rho1-tt8", "k7-rho1-tt256", "k7-rho2-tt1",
          "k7-rho2-tt8", "k7-rho2-tt256", "tbcc-rho2-tt8", "k7-one-row"]


def _k6_inputs(code, rho, tt, n_tiles, F, final=None, seed=11):
    """(tables, reverse tables, half-scaled blocks (T', F, B) in the
    strided layout ``bcjr_llrs`` makes, tile-entry alphas and tile-end
    betas (N, F, S)) of AWGN codeword LLRs."""
    from repro_torch.core import soft
    from repro_torch.core.trellis import build_acs_tables, build_reverse_tables
    from repro_torch.core.viterbi import AcsPrecision, blocks_from_llrs, init_metric

    spec, _ = _specs(code)
    tb, rev = build_acs_tables(spec, rho), build_reverse_tables(spec, rho)
    llrs = _llrs(spec, F, n_tiles * tt * rho, seed=seed, ebn0_db=1.0, tail="open")
    blocks = blocks_from_llrs(torch.from_numpy(llrs), rho) * 0.5
    S = spec.n_states
    lam0 = init_metric(F, S, 0, device="cpu")
    beta_end = init_metric(F, S, final, device="cpu")
    entry, bte = soft._tile_boundaries(blocks, lam0, beta_end, tb, AcsPrecision(), tt, True)
    return tb, rev, blocks, lam0, beta_end, entry, bte


@pytest.mark.parametrize("code,rho,tt,n_tiles,F", K6_CASES, ids=K6_IDS)
def test_k6_plain_version_is_the_plain_sweeps(code, rho, tt, n_tiles, F):
    """K6's plain version (the kernel's gathered step and tournament
    logsumexp, the combine per boundary) against today's composition of
    ``_alpha_scan``, ``_beta_scan`` and ``_llrs_from_joints``, within
    1e-5; and the wrapper's two halves on CPU tensors are that plain
    version and launch nothing."""
    from repro_torch.core import soft
    from repro_torch.core.viterbi import AcsPrecision
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import bcjr_sweep_ref

    tb, rev, blocks, lam0, beta_end, entry, bte = _k6_inputs(code, rho, tt, n_tiles, F)
    joint = soft._bcjr_joints(blocks, lam0, beta_end, tb, rev, AcsPrecision(), tt, True)
    want = soft._llrs_from_joints(joint, tb)
    fwd = viterbi_acs.sweep_operands(tb.theta_t, tb.pred_onehot, tb.dec_bits)
    bwd = viterbi_acs.sweep_operands(rev.theta_rev, rev.succ_onehot, tb.dec_bits)
    got = bcjr_sweep_ref(blocks, entry, bte, fwd, bwd, transfer_tile=tt)
    assert got.shape == (F, n_tiles * tt * rho) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    launches = viterbi_acs.bcjr_sweep.launches
    alphas = viterbi_acs.bcjr_sweep(blocks, entry, fwd, transfer_tile=tt)
    assert alphas.shape == (tt, n_tiles * F, tb.n_states)
    halves = viterbi_acs.bcjr_sweep(blocks, bte, bwd, transfer_tile=tt, alphas=alphas)
    assert torch.equal(halves, got)
    assert viterbi_acs.bcjr_sweep.launches == launches


@pytest.mark.parametrize("code,rho,tt,final", [
    ("ccsds-k7", 1, 8, None),
    ("ccsds-k7", 2, 8, 0),
    ("ccsds-k7", 2, 1, None),
    ("lte-tbcc", 2, 4, None),
    (K5, 2, 8, 0),
], ids=["k7-rho1-open", "k7-rho2-pinned", "k7-rho2-tt1", "tbcc-rho2", "k5-pinned"])
def test_k6_route_matches_the_reference(code, rho, tt, final, monkeypatch):
    """The K6 route of ``bcjr_llrs`` (forced; its plain version on the
    CPU) against the reference's ``bcjr_llrs`` (XLA path), and K6's plain
    version (``bcjr_sweep_ref``) on the port's tile boundaries against the
    reference's ``_llrs_from_joints(_bcjr_joints(...))``, on the same
    numpy LLRs, at the BCJR parity tolerance."""
    import jax.numpy as jnp
    from repro.core import soft as ref_soft
    from repro.core.trellis import build_acs_tables as ref_acs_tables
    from repro.core.trellis import build_reverse_tables as ref_reverse_tables
    from repro.core.viterbi import AcsPrecision as RefPrecision
    from repro.core.viterbi import blocks_from_llrs as ref_blocks
    from repro.core.viterbi import init_metric as ref_init

    from repro_torch.core import soft
    from repro_torch.core.trellis import build_acs_tables, build_reverse_tables
    from repro_torch.core.viterbi import AcsPrecision, blocks_from_llrs, init_metric
    from repro_torch.kernels import viterbi_acs
    from repro_torch.kernels.ref import bcjr_sweep_ref

    spec, ref_spec = _specs(code)
    F, n = 3, 4 * tt * rho
    llrs = _llrs(spec, F, n, seed=16, tail="flush")
    monkeypatch.setattr(soft, "_sweeps_in_kernel", lambda dev, use_kernel: use_kernel)
    got = soft.bcjr_llrs(torch.from_numpy(llrs), spec, rho=rho, final_state=final,
                         transfer_tile=tt, device="cpu")
    want = ref_soft.bcjr_llrs(jnp.asarray(llrs), ref_spec, rho=rho, final_state=final,
                              transfer_tile=tt)
    _close_llrs(got.numpy(), want)

    tb, rev = build_acs_tables(spec, rho), build_reverse_tables(spec, rho)
    S = spec.n_states
    blocks = blocks_from_llrs(torch.from_numpy(llrs), rho) * 0.5
    entry, bte = soft._tile_boundaries(
        blocks, init_metric(F, S, 0, device="cpu"), init_metric(F, S, final, device="cpu"),
        tb, AcsPrecision(), tt, True)
    fwd = viterbi_acs.sweep_operands(tb.theta_t, tb.pred_onehot, tb.dec_bits)
    bwd = viterbi_acs.sweep_operands(rev.theta_rev, rev.succ_onehot, tb.dec_bits)
    sweep = bcjr_sweep_ref(blocks, entry, bte, fwd, bwd, transfer_tile=tt)
    ref_tb = ref_acs_tables(ref_spec, rho)
    joint = ref_soft._bcjr_joints(
        ref_blocks(jnp.asarray(llrs), rho) * jnp.float32(0.5), ref_init(F, S, 0),
        ref_init(F, S, final), ref_tb, ref_reverse_tables(ref_spec, rho), RefPrecision(),
        tt, False)
    _close_llrs(sweep.numpy(), ref_soft._llrs_from_joints(joint, ref_tb))


@pytest.mark.parametrize("knobs", [
    dict(matmul_dtype=torch.bfloat16, carry_dtype=torch.bfloat16),
    dict(matmul_dtype=torch.bfloat16, split_dot=True),
    dict(renorm=False),
    dict(channel_dtype=torch.bfloat16),
], ids=["bf16", "split", "norenorm", "channel-bf16"])
@pytest.mark.parametrize("final", [None, 0], ids=["open", "pinned"])
def test_k6_plain_version_keeps_every_rounding_point(knobs, final, monkeypatch):
    """Under each precision knob, and with a pinned end (whose forced bits
    saturate near 1e9), ``bcjr_llrs`` through the K6 route (its plain
    version, on the CPU) gives the plain scans' LLRs within 1e-5."""
    from repro_torch.core import soft
    from repro_torch.core.viterbi import AcsPrecision

    spec, _ = _specs("ccsds-k7")
    llrs = torch.from_numpy(_llrs(spec, 3, 64, seed=12, ebn0_db=1.0, tail="flush"))
    prec = AcsPrecision(**knobs)
    kw = dict(final_state=final, precision=prec, transfer_tile=8, device="cpu")
    want = soft.bcjr_llrs(llrs, spec, **kw)
    monkeypatch.setattr(soft, "_sweeps_in_kernel", lambda dev, use_kernel: use_kernel)
    got = soft.bcjr_llrs(llrs, spec, **kw)
    sat = want.abs() > SAT
    assert torch.equal(got.abs() > SAT, sat) and (sat.any() == (final is not None))
    assert torch.equal(got[sat], want[sat])
    torch.testing.assert_close(got[~sat], want[~sat], atol=1e-5, rtol=0)


def test_k6_route_index_is_the_one_hot():
    """The routing index of ``pred_onehot`` and ``succ_onehot`` is each
    column's predecessor and successor (``pred_state``, ``succ_state``)
    and rebuilds the one-hot; a routing half that is not a one-hot
    raises."""
    from repro_torch.core.trellis import build_acs_tables, build_reverse_tables
    from repro_torch.kernels.viterbi_acs import route_index, sweep_operands

    for code, rho in (("ccsds-k7", 1), ("ccsds-k7", 2), ("lte-tbcc", 3), (K5, 4)):
        spec, _ = _specs(code)
        tb, rev = build_acs_tables(spec, rho), build_reverse_tables(spec, rho)
        S, R = tb.n_states, tb.n_slots
        for onehot, states in ((tb.pred_onehot, tb.pred_state),
                               (rev.succ_onehot, rev.succ_state)):
            route = route_index(onehot)
            assert torch.equal(route, torch.from_numpy(states).reshape(-1).long())
            rebuilt = torch.zeros(S, S * R)
            rebuilt[route, torch.arange(S * R)] = 1.0
            assert torch.equal(rebuilt, torch.from_numpy(onehot))
        ops = sweep_operands(tb.theta_t, tb.pred_onehot, tb.dec_bits)
        bits = (ops.dec[:, None].long() >> torch.arange(rho)) & 1
        assert torch.equal(bits, torch.from_numpy(tb.dec_bits).long())
    base = torch.from_numpy(build_acs_tables(_specs("ccsds-k7")[0], 2).pred_onehot)
    two = base.clone()
    two[0, 5] = 1.0  # a second 1 in a column
    half = base.clone()
    half[:, 3] *= 0.5  # not a 1
    empty = base.clone()
    empty[:, 7] = 0.0  # no 1
    for bad in (two, half, empty):
        with pytest.raises(ValueError, match="one 1.0 per column"):
            route_index(bad)
        with pytest.raises(ValueError, match="one 1.0 per column"):
            sweep_operands(np.zeros((4, 256), np.float32), bad, np.zeros((64, 2)))


def _spy_sweeps(monkeypatch):
    """The K6 calls of ``bcjr_llrs`` counted (the real wrapper runs), and
    the plain step made to fail."""
    from repro_torch.core import soft
    from repro_torch.kernels import ops as kernel_ops

    calls = []
    real = kernel_ops.bcjr_sweep

    def spy(*args, **kw):
        calls.append("K6-B" if kw.get("alphas") is not None else "K6-F")
        return real(*args, **kw)

    monkeypatch.setattr(kernel_ops, "bcjr_sweep", spy)
    return calls, soft


def test_bcjr_llrs_takes_k6_only_on_the_card_route(monkeypatch):
    """On CPU tensors, with or without ``use_kernel``, ``bcjr_llrs`` runs
    the plain scans and never calls K6's wrapper; on the card's route
    with ``use_kernel`` (the route forced here) it calls K6-F then K6-B,
    takes no plain step and no plain combine, and gives the plain scans'
    LLRs within 1e-5; with ``use_kernel=False`` the card's route is the
    plain scans too."""
    calls, soft = _spy_sweeps(monkeypatch)
    spec, _ = _specs("ccsds-k7")
    llrs = torch.from_numpy(_llrs(spec, 2, 128, seed=13, ebn0_db=1.0))
    kw = dict(transfer_tile=8, device="cpu")
    plain = {uk: soft.bcjr_llrs(llrs, spec, use_kernel=uk, **kw) for uk in (True, False)}
    assert calls == []
    monkeypatch.setattr(soft, "_sweeps_in_kernel", lambda dev, use_kernel: use_kernel)
    assert torch.equal(soft.bcjr_llrs(llrs, spec, use_kernel=False, **kw), plain[False])
    assert calls == []

    def no_plain(*args, **kw):
        raise AssertionError("a plain step or combine on the kernel route")

    monkeypatch.setattr(soft, "_logprob_step", no_plain)
    monkeypatch.setattr(soft, "_llrs_from_joints", no_plain)
    got = soft.bcjr_llrs(llrs, spec, use_kernel=True, **kw)
    assert calls == ["K6-F", "K6-B"]
    torch.testing.assert_close(got, plain[True], atol=1e-5, rtol=0)


def test_k6_route_stages_carry_no_steps(monkeypatch):
    """On the kernel route the ``alpha`` and ``beta`` stages hold the two
    K6 calls and carry no ``steps`` and no host sync; ``llr_combine``
    opens only on the plain route."""
    from repro_torch.obs import trace as rt

    calls, soft = _spy_sweeps(monkeypatch)
    spec, _ = _specs("ccsds-k7")
    llrs = torch.from_numpy(_llrs(spec, 2, 128, seed=14, ebn0_db=1.0))
    prev = rt.set_default_recorder(rt.SpanRecorder())
    try:
        for route in (False, True):
            monkeypatch.setattr(soft, "_sweeps_in_kernel", lambda dev, uk, r=route: r)
            rt.reset_stage_totals()
            soft.bcjr_llrs(llrs, spec, transfer_tile=8, device="cpu")
            totals = rt.stage_totals()
            if route:
                assert "llr_combine" not in totals
                assert {s: (totals[s]["steps"], totals[s]["host_syncs"])
                        for s in ("alpha", "beta")} == {"alpha": (0, 0), "beta": (0, 0)}
            else:
                assert totals["alpha"]["steps"] == 8 and totals["beta"]["steps"] == 7
                assert totals["llr_combine"]["host_syncs"] == 2
    finally:
        rt.set_default_recorder(prev)
        rt.reset_stage_totals()
    assert calls == ["K6-F", "K6-B"]


@pytest.mark.parametrize("knob", ["carry_dtype", "matmul_dtype"])
def test_k6_refuses_a_precision_it_cannot_match(knob, monkeypatch):
    """A carry or matmul dtype K6 has no instantiation for (float16)
    raises ``ValueError`` naming the knob on the kernel's route, before
    any sweep, where the CPU's plain route runs it."""
    from repro_torch.core import soft
    from repro_torch.core.viterbi import AcsPrecision

    spec, _ = _specs("ccsds-k7")
    llrs = torch.from_numpy(_llrs(spec, 2, 64, seed=15, ebn0_db=1.0))
    prec = AcsPrecision(**{knob: torch.float16})
    kw = dict(precision=prec, transfer_tile=8, device="cpu")
    assert soft.bcjr_llrs(llrs, spec, **kw).shape == (2, 64)
    monkeypatch.setattr(soft, "_sweeps_in_kernel", lambda dev, use_kernel: use_kernel)
    with pytest.raises(ValueError, match=knob):
        soft.bcjr_llrs(llrs, spec, **kw)
