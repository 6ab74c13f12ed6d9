"""The port's numpy and data-making modules against the reference:
trellis tables (every registry spec x rho in {1, 2, 3}), tables carried
across with ``tables_from_numpy``, the encoders, the channel and the
scalar oracle."""
import numpy as np
import pytest
import torch

from repro_torch.codes import REGISTRY as PORT_REGISTRY

SPECS = sorted({(c.spec.k, c.spec.polys) for c in PORT_REGISTRY.values()})
FIELDS = ("theta_t", "pred_onehot", "pred_state", "dec_bits", "fused_w")


def _ref_spec(spec):
    from repro.core.trellis import CodeSpec as RefSpec

    return RefSpec(k=spec.k, polys=spec.polys)


def _port_spec(k, polys):
    from repro_torch.core.trellis import CodeSpec

    return CodeSpec(k=k, polys=polys)


@pytest.mark.parametrize("rho", [1, 2, 3])
@pytest.mark.parametrize("k,polys", SPECS, ids=[f"k{k}-{p}" for k, p in SPECS])
def test_acs_tables_equal_reference(k, polys, rho):
    from repro.core.trellis import build_acs_tables as ref_build

    from repro_torch.core.trellis import build_acs_tables

    spec = _port_spec(k, polys)
    ours, ref = build_acs_tables(spec, rho), ref_build(_ref_spec(spec), rho)
    assert (ours.n_states, ours.n_slots, ours.llr_block) == (
        ref.n_states, ref.n_slots, ref.llr_block)
    for name in FIELDS:
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("k,polys", SPECS, ids=[f"k{k}-{p}" for k, p in SPECS])
def test_transitions_equal_reference(k, polys):
    from repro.core.trellis import build_transitions as ref_transitions

    from repro_torch.core.trellis import build_transitions

    spec = _port_spec(k, polys)
    ours, ref = build_transitions(spec), ref_transitions(_ref_spec(spec))
    for name in ("next_state", "out_bits", "prev_state", "prev_bit"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))


def test_tables_carried_across_decode_like_built_ones():
    """Tables rebuilt from the reference's arrays decode exactly as the
    port's own tables do (decode_frames builds its own)."""
    from repro.core.trellis import build_acs_tables as ref_build

    from repro_torch.core import CODE_K7_CCSDS, decode_frames, tables_from_numpy
    from repro_torch.core.viterbi import (
        blocks_from_llrs, forward_fused, init_metric, traceback,
    )

    ref = ref_build(_ref_spec(CODE_K7_CCSDS), 2)
    carried = tables_from_numpy(
        CODE_K7_CCSDS, 2, {name: getattr(ref, name) for name in FIELDS}
    )
    rng = np.random.default_rng(7)
    llrs = torch.from_numpy(rng.normal(0, 2, (6, 40, 2)).astype(np.float32))
    for use_kernel in (True, False):
        lam, phis = forward_fused(
            blocks_from_llrs(llrs, 2), init_metric(6, 64, 0, "cpu"), carried,
            use_kernel=use_kernel,
        )
        bits = traceback(phis, lam.argmax(dim=-1), carried)
        built = decode_frames(llrs, CODE_K7_CCSDS, use_kernel=use_kernel,
                              device="cpu")
        assert torch.equal(bits, built)


def test_tables_from_numpy_rejects_bad_arrays():
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables, tables_from_numpy

    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    arrays = {name: getattr(tb, name) for name in FIELDS}
    with pytest.raises(ValueError, match="missing"):
        tables_from_numpy(CODE_K7_CCSDS, 2, {"theta_t": tb.theta_t})
    with pytest.raises(ValueError, match="shape"):
        tables_from_numpy(CODE_K7_CCSDS, 1, arrays)
    bad = dict(arrays, fused_w=np.zeros_like(tb.fused_w))
    with pytest.raises(ValueError, match="fused_w"):
        tables_from_numpy(CODE_K7_CCSDS, 2, bad)


@pytest.mark.parametrize("name", ["ccsds-k7", "gsm-cs1", "lte-tbcc"])
def test_encoders_equal_reference(name):
    import jax.numpy as jnp
    from repro.core.encoder import conv_encode as ref_encode
    from repro.core.encoder import conv_encode_jax, tail_flush as ref_flush

    from repro_torch.core import conv_encode, conv_encode_torch, tail_flush

    spec = PORT_REGISTRY[name].spec
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (5, 37))
    for s0 in (0, 5):
        ref = np.asarray(conv_encode_jax(
            jnp.asarray(bits), _ref_spec(spec), initial_state=s0
        ))
        np.testing.assert_array_equal(
            conv_encode_torch(torch.from_numpy(bits), spec, s0).numpy(), ref
        )
        for row, r in zip(bits, ref):
            np.testing.assert_array_equal(conv_encode(row, spec, s0), r)
            np.testing.assert_array_equal(
                ref_encode(row, _ref_spec(spec), s0), r
            )
    np.testing.assert_array_equal(
        tail_flush(bits[0], spec), ref_flush(bits[0], _ref_spec(spec))
    )


def test_channel_equals_reference():
    import jax.numpy as jnp
    from repro.core import channel as ref

    from repro_torch.core import channel

    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (3, 50, 2))
    np.testing.assert_array_equal(channel.bpsk(bits).numpy(), np.asarray(ref.bpsk(bits)))
    for ebn0, rate in ((4.0, 0.5), (1.5, 1 / 3)):
        assert channel.awgn_sigma(ebn0, rate) == ref.awgn_sigma(ebn0, rate)
        y = rng.normal(0, 1, (4, 9)).astype(np.float32)
        np.testing.assert_allclose(
            channel.llr(torch.from_numpy(y), ebn0, rate).numpy(),
            np.asarray(ref.llr(jnp.asarray(y), ebn0, rate)), rtol=1e-6,
        )
    # noise: reproducible from the generator's seed, with the right sigma
    sym = channel.bpsk(torch.zeros(200_000))
    draws = [
        channel.awgn(torch.Generator().manual_seed(11), sym, 2.0, 0.5)
        for _ in range(2)
    ]
    assert torch.equal(draws[0], draws[1])
    noise = (draws[0] - sym).double()
    assert abs(noise.std().item() / channel.awgn_sigma(2.0, 0.5) - 1) < 0.01
    assert abs(noise.mean().item()) < 0.01


def test_scalar_oracle_equals_reference():
    from repro.core.viterbi_ref import viterbi_decode_ref as ref_decode

    from repro_torch.core import CODE_K7_CCSDS, viterbi_decode_ref

    rng = np.random.default_rng(5)
    llrs = rng.normal(0, 2, (30, 2))
    for s0, sf in ((0, None), (None, None), (0, 0)):
        np.testing.assert_array_equal(
            viterbi_decode_ref(llrs, CODE_K7_CCSDS, s0, sf),
            ref_decode(llrs, _ref_spec(CODE_K7_CCSDS), s0, sf),
        )


# -- the paper-layout helpers, on the reference's test_trellis.py codes -------

PAPER_CODES = [(7, (0o171, 0o133)), (3, (0o7, 0o5)), (5, (0o27, 0o31)),
               (7, (0o171, 0o133, 0o165)), (9, (0o561, 0o753))]


@pytest.mark.parametrize("k,polys", PAPER_CODES,
                         ids=[f"k{k}b{len(p)}" for k, p in PAPER_CODES])
def test_butterflies_and_branch_outputs_equal_reference(k, polys):
    """``msb_lsb_one``, ``branch_output`` at every (state, bit) and
    ``butterfly_states`` at every butterfly, and both refuse the same
    out-of-range butterfly."""
    from repro.core import trellis as ref

    from repro_torch.core import trellis

    spec, rspec = _port_spec(k, polys), _ref_spec(_port_spec(k, polys))
    assert spec.msb_lsb_one == rspec.msb_lsb_one
    for s in range(spec.n_states):
        for u in (0, 1):
            assert trellis.branch_output(spec, s, u) == ref.branch_output(rspec, s, u)
    half = spec.n_states // 2
    for f in range(half):
        assert trellis.butterfly_states(spec, f) == ref.butterfly_states(rspec, f)
    for bad in (-1, half):
        with pytest.raises(ValueError, match="out of range"):
            trellis.butterfly_states(spec, bad)
        with pytest.raises(ValueError, match="out of range"):
            ref.butterfly_states(rspec, bad)


DRAGONFLY_CASES = [(k, p, rho) for k, p in PAPER_CODES for rho in (1, 2, 3)
                   if rho <= k - 2]


@pytest.mark.parametrize("k,polys,rho", DRAGONFLY_CASES,
                         ids=[f"k{k}b{len(p)}-rho{r}" for k, p, r in DRAGONFLY_CASES])
def test_dragonflies_equal_reference(k, polys, rho):
    """``dragonfly_state`` at every (f, y, x), ``dragonfly_theta`` and
    ``dragonfly_output_table`` of every dragonfly, and ``dragonfly_groups``
    (at rho <= 2, where the permutation search stays small)."""
    from repro.core import trellis as ref

    from repro_torch.core import trellis

    spec = _port_spec(k, polys)
    rspec = _ref_spec(spec)
    n_df = spec.n_states >> rho
    for f in range(n_df):
        for y in range(1 << rho):
            for x in range(rho + 1):
                assert trellis.dragonfly_state(spec, rho, f, y, x) == (
                    ref.dragonfly_state(rspec, rho, f, y, x))
        np.testing.assert_array_equal(trellis.dragonfly_theta(spec, rho, f),
                                      ref.dragonfly_theta(rspec, rho, f))
        np.testing.assert_array_equal(trellis.dragonfly_output_table(spec, rho, f),
                                      ref.dragonfly_output_table(rspec, rho, f))
    with pytest.raises(ValueError, match="dragonfly index"):
        trellis.dragonfly_state(spec, rho, n_df, 0, 0)
    with pytest.raises(ValueError, match="local indices"):
        trellis.dragonfly_state(spec, rho, 0, 1 << rho, 0)
    if rho <= 2:
        groups, tables = trellis.dragonfly_groups(spec, rho)
        rgroups, rtables = ref.dragonfly_groups(rspec, rho)
        assert groups == rgroups
        for a, b in zip(tables, rtables, strict=True):
            np.testing.assert_array_equal(a, b)


def test_fig10_theta0_and_k7_groups():
    """The reference's Fig. 10 cases: dragonfly 0's output table of the
    (2,1,7) code and its dragonfly groups at rho = 2, as the reference
    computes them."""
    from repro.core import trellis as ref

    from repro_torch.core import trellis

    spec = trellis.CODE_K7_CCSDS
    np.testing.assert_array_equal(
        trellis.dragonfly_output_table(spec, 2, 0),
        ref.dragonfly_output_table(ref.CODE_K7_CCSDS, 2, 0))
    groups, _ = trellis.dragonfly_groups(spec, rho=2)
    assert sorted(map(sorted, groups.values())) == sorted(
        map(sorted, ref.dragonfly_groups(ref.CODE_K7_CCSDS, rho=2)[0].values()))
