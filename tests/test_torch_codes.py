"""The standard-codes slice, part 1: ``repro_torch.codes.puncture``, the
tail-biting encoders and ``repro_torch.codes.tailbiting.wava_decode``
against ``repro``'s, on the same numpy-seeded inputs.

The reference runs as ``tests/test_codes.py`` runs it: its K1 in
interpret mode on the CPU where ``use_kernel=True``.  The port runs on
CPU tensors, so its wrappers take their plain versions.  Nothing here
needs a tolerance: puncturing moves values, and the decodes run on
integer LLRs (every f32 sum exact in any order) or on Gaussian LLRs that
both packages sum in the same order.
"""
import numpy as np
import pytest
import torch

REGISTRY_PATTERNS = ["dvb-s-r78", "wifi-11a-r23", "wifi-11a-r34", "wifi-11a-r56"]
SPEC_K3 = dict(k=3, polys=(0o7, 0o5))


def _patterns(which):
    """(port pattern, reference pattern) of a registry code or an
    identity pattern ("identity-<beta>")."""
    from repro.codes.puncture import identity_pattern as ref_identity
    from repro.codes.registry import get_code as ref_get_code

    from repro_torch.codes.puncture import identity_pattern
    from repro_torch.codes.registry import get_code

    if which.startswith("identity-"):
        beta = int(which.split("-")[1])
        return identity_pattern(beta), ref_identity(beta)
    return get_code(which).puncture, ref_get_code(which).puncture


def _ref_spec(spec):
    from repro.core.trellis import CodeSpec as RefSpec

    return RefSpec(k=spec.k, polys=spec.polys)


# -- puncture / depuncture ---------------------------------------------------

@pytest.mark.parametrize("which", REGISTRY_PATTERNS + ["identity-2", "identity-3"])
def test_puncture_and_depuncture_equal_the_reference(which):
    import jax.numpy as jnp
    from repro.codes.puncture import depuncture as ref_depuncture
    from repro.codes.puncture import puncture as ref_puncture

    from repro_torch.codes.puncture import depuncture, puncture

    pat, ref = _patterns(which)
    assert (pat.period, pat.beta, pat.n_kept, pat.expansion) == (
        ref.period, ref.beta, ref.n_kept, ref.expansion)
    rng = np.random.default_rng(len(which))
    for n in range(1, 3 * pat.period + 2):
        np.testing.assert_array_equal(pat.kept_indices(n), ref.kept_indices(n))
        assert pat.punctured_len(n) == ref.punctured_len(n)
        for lead in ((), (3,), (2, 3)):
            # no zeros in the input, so every erasure shows as an exact 0
            x = rng.uniform(0.5, 2.0, lead + (n, pat.beta)).astype(np.float32)
            x *= rng.choice([-1.0, 1.0], x.shape).astype(np.float32)
            kept = puncture(torch.as_tensor(x), pat)
            want = np.asarray(ref_puncture(jnp.asarray(x), ref))
            assert kept.shape == lead + (pat.punctured_len(n),)
            np.testing.assert_array_equal(kept.numpy(), want)
            back = depuncture(kept, pat, n=n)
            np.testing.assert_array_equal(
                back.numpy(), np.asarray(ref_depuncture(jnp.asarray(want), ref, n=n))
            )
            mask = pat._tiled_mask(n)
            np.testing.assert_array_equal(back.numpy()[..., mask], x[..., mask])
            assert (back.numpy()[..., ~mask] == 0).all()


@pytest.mark.parametrize("which", REGISTRY_PATTERNS + ["identity-2", "identity-3"])
def test_stages_for_equals_the_reference_and_refuses_alike(which):
    pat, ref = _patterns(which)
    for lp in range(0, 3 * pat.n_kept + 2):
        try:
            want = ref.stages_for(lp)
        except ValueError:
            with pytest.raises(ValueError, match="does not align"):
                pat.stages_for(lp)
            continue
        assert pat.stages_for(lp) == want
        assert pat.punctured_len(want) == lp


def test_depuncture_defaults_to_stages_for_and_checks_the_length():
    from repro_torch.codes.puncture import depuncture, puncture

    pat, _ = _patterns("wifi-11a-r34")
    x = torch.arange(1.0, 49.0).reshape(24, 2)
    kept = puncture(x, pat)
    assert depuncture(kept, pat).shape == (pat.stages_for(kept.shape[-1]), 2)
    with pytest.raises(ValueError, match="inconsistent"):
        depuncture(kept, pat, n=25)
    with pytest.raises(ValueError, match="beta"):
        puncture(torch.zeros(6, 3), pat)


def test_pattern_validation():
    from repro_torch.codes import PuncturePattern

    for bad in (((0, 0),), ((1, 2),), ((1,), (1, 0)), ()):
        with pytest.raises(ValueError):
            PuncturePattern(mask=bad)
    with pytest.raises(ValueError, match="beta"):
        PuncturePattern(mask=((1, 1),)).rate(3)


# -- tail-biting encoders ----------------------------------------------------

@pytest.mark.parametrize("name", ["ccsds-k7", "wifi-11a", "gsm-cs1", "lte-tbcc", "k3"])
def test_tail_bite_encoders_equal_the_reference_and_close_the_circle(name):
    import jax.numpy as jnp
    from repro.core.encoder import conv_encode_jax
    from repro.core.encoder import tail_bite_state as ref_state

    from repro_torch.codes import get_code
    from repro_torch.core import CodeSpec, build_transitions
    from repro_torch.core.encoder import (
        conv_encode,
        conv_encode_torch,
        tail_bite_state,
    )

    spec = CodeSpec(**SPEC_K3) if name == "k3" else get_code(name).spec
    tr = build_transitions(spec)
    rng = np.random.default_rng(spec.k)
    bits = rng.integers(0, 2, (2, 3, 50))
    want = np.asarray(conv_encode_jax(jnp.asarray(bits), _ref_spec(spec),
                                      tail_bite=True))
    got = conv_encode_torch(torch.as_tensor(bits), spec, tail_bite=True)
    np.testing.assert_array_equal(got.numpy(), want)
    for row in bits.reshape(-1, 50):
        s0 = tail_bite_state(row, spec.k)
        assert s0 == ref_state(row, spec.k)
        np.testing.assert_array_equal(
            conv_encode(row, spec, tail_bite=True),
            conv_encode(row, spec, initial_state=s0),
        )
        s = s0
        for u in row:
            s = int(tr.next_state[s, u])
        assert s == s0
    with pytest.raises(ValueError, match="k-1"):
        tail_bite_state(bits[0, 0, :spec.k - 2], spec.k)
    with pytest.raises(ValueError, match="k-1"):
        conv_encode_torch(torch.zeros(spec.k - 2, dtype=torch.int64), spec,
                          tail_bite=True)


def test_hard_decision_equals_the_reference():
    import jax.numpy as jnp
    from repro.core.channel import hard_decision as ref_hard

    from repro_torch.core.channel import hard_decision

    rx = np.random.default_rng(5).normal(size=(4, 33, 2)).astype(np.float32)
    rx[0, :3] = 0.0
    got = hard_decision(torch.as_tensor(rx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_hard(jnp.asarray(rx))))


# -- WAVA --------------------------------------------------------------------

def _tb_llrs(spec, n_frames, n_bits, sigma, seed, integer=True):
    """(bits, LLRs (F, n, beta) float32) of tail-biting codewords of
    ``spec`` with the bpsk convention (bit 0 -> +1)."""
    from repro_torch.core.encoder import conv_encode

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (n_frames, n_bits))
    llr = np.stack([1.0 - 2.0 * conv_encode(b, spec, tail_bite=True) for b in bits])
    llr = llr + rng.normal(0.0, sigma, llr.shape)
    if integer:
        llr = np.clip(np.round(2.0 * llr), -8, 8)
    return bits, llr.astype(np.float32)


def _wava_pair(rho):
    from repro.core.trellis import build_acs_tables as ref_tables

    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables

    spec = get_code("lte-tbcc").spec
    return spec, build_acs_tables(spec, rho), ref_tables(_ref_spec(spec), rho)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("rho", [1, 2])
def test_wava_equals_the_reference(rho, packed, use_kernel):
    """Bits and converged flags at every circulation count 1-4, on noisy
    integer LLRs where some frames converge late or never."""
    import jax.numpy as jnp
    from repro.codes.tailbiting import wava_decode as ref_wava

    from repro_torch.codes import wava_decode

    spec, tables, ref_tables = _wava_pair(rho)
    _, llr = _tb_llrs(spec, 6, 24, 1.1, seed=rho + 2 * packed)
    for iters in (1, 2, 3, 4):
        bits, conv = wava_decode(
            llr, tables, use_kernel=use_kernel, pack_survivors=packed,
            max_iters=iters, device="cpu",
        )
        want_bits, want_conv = ref_wava(
            jnp.asarray(llr), ref_tables, use_kernel=use_kernel,
            pack_survivors=packed, max_iters=iters,
        )
        assert bits.dtype == torch.int32 and conv.dtype == torch.bool
        np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
        np.testing.assert_array_equal(conv.numpy(), np.asarray(want_conv))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_wava_time_parallel_prefix_path_equals_the_reference(use_kernel):
    """``time_parallel=True, transfer_tile=8``: the transfer prefix once,
    then one recovery per circulation; the same bits and flags as the
    reference's, and as the sequential circulations on Gaussian LLRs."""
    import jax.numpy as jnp
    from repro.codes.tailbiting import wava_decode as ref_wava

    from repro_torch.codes import wava_decode

    spec, tables, ref_tables = _wava_pair(2)
    _, llr = _tb_llrs(spec, 3, 128, 0.9, seed=3, integer=False)
    kw = dict(use_kernel=use_kernel, max_iters=2)
    got = wava_decode(llr, tables, time_parallel=True, transfer_tile=8,
                      device="cpu", **kw)
    want = ref_wava(jnp.asarray(llr), ref_tables, time_parallel=True,
                    transfer_tile=8, **kw)
    seq = wava_decode(llr, tables, device="cpu", **kw)
    for g, w, s in zip(got, want, seq):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), s.numpy())


def test_wava_standalone_time_parallel_plans_its_own_tile():
    """Without a tile the shared plan decides: 64 steps take tiles of 16
    (four tiles), 8 steps are too short to tile and stay sequential."""
    from repro_torch.codes import wava_decode

    spec, tables, _ = _wava_pair(2)
    for n in (128, 16):
        _, llr = _tb_llrs(spec, 2, n, 0.5, seed=n, integer=False)
        got = wava_decode(llr, tables, time_parallel=True, device="cpu")
        want = wava_decode(llr, tables, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_wava_equals_brute_force_circular_k3(seed):
    """WAVA against ``tests/oracle.py``'s enumeration of every tail-biting
    codeword of a k = 3 code, as ``tests/test_codes.py`` holds the
    reference."""
    from oracle import ml_path

    from repro_torch.codes import tail_bite_state, wava_decode
    from repro_torch.core import CodeSpec, build_acs_tables, conv_encode

    spec = CodeSpec(**SPEC_K3)
    rng = np.random.default_rng(seed)
    n = 16
    bits = rng.integers(0, 2, n)
    llr = 1.0 - 2.0 * conv_encode(bits, spec, tail_bite=True).astype(np.float64)
    llr = llr + rng.normal(0.0, 0.45, llr.shape)
    want_bits, want_metric = ml_path(llr, _ref_spec(spec), tail_bite=True)
    got, conv = wava_decode(
        torch.as_tensor(llr, dtype=torch.float32)[None],
        build_acs_tables(spec, 2), max_iters=8, device="cpu",
    )
    got = got[0].numpy()
    assert bool(conv[0])
    s0 = tail_bite_state(got, spec.k)
    got_metric = float(
        ((1.0 - 2.0 * conv_encode(got, spec, initial_state=s0)) * llr).sum()
    )
    np.testing.assert_allclose(got_metric, want_metric, rtol=1e-6)
    np.testing.assert_array_equal(got, want_bits)


def test_wava_refuses_like_the_reference():
    from repro_torch.codes import wava_decode

    spec, tables, _ = _wava_pair(2)
    with pytest.raises(ValueError, match="beta"):
        wava_decode(np.zeros((1, 8, 2), np.float32), tables, device="cpu")
    with pytest.raises(ValueError, match="rho=1"):
        wava_decode(np.zeros((1, 9, 3), np.float32), tables, device="cpu")
