"""The standard-codes slice, part 3: ``repro_torch.core.ber``,
``repro_torch.codes.simulate``, ``repro_torch.data.ChannelStream`` and the
two smoke modules, against ``repro``'s where the two can agree.

The estimators are plain Python in both packages and must agree to rel
1e-12.  The noise cannot be the reference's (``jax.random`` streams are
not reproducible in PyTorch), so the pipeline is held on what does not
depend on it (transmit frames, encoding, puncturing, error counts, the
LLR formula on the same noise) and on being deterministic from its seed.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CODES = ["ccsds-k7", "dvb-s", "dvb-s-r78", "gsm-cs1", "lte-tbcc", "wifi-11a",
         "wifi-11a-r23", "wifi-11a-r34", "wifi-11a-r56"]


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


# -- core/ber.py: the estimators ----------------------------------------------

GRID = [(k, n) for n in (1, 7, 100, 4096, 10**6) for k in sorted({0, 1, n // 3, n})]


@pytest.mark.parametrize("method", ["clopper-pearson", "wilson"])
@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
def test_estimators_equal_the_reference(confidence, method):
    from repro.core import ber as ref

    from repro_torch.core import ber

    for k, n in GRID:
        got = ber.estimate_ber(k, n, confidence, method)
        want = ref.estimate_ber(k, n, confidence, method)
        for field in ("n_bits", "n_errors", "confidence", "method",
                      "upper_bound", "reliable"):
            assert getattr(got, field) == getattr(want, field)
        for field in ("ber", "ci_lo", "ci_hi"):
            np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                       rtol=1e-12, atol=0)
        np.testing.assert_allclose(ber.wilson_interval(k, n, confidence),
                                   ref.wilson_interval(k, n, confidence),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(ber.clopper_pearson(k, n, confidence),
                                   ref.clopper_pearson(k, n, confidence),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(ber.zero_error_upper(n, confidence),
                                   ref.zero_error_upper(n, confidence),
                                   rtol=1e-12, atol=0)
        assert ber.rule_of_three(n) == ref.rule_of_three(n)
        pt, ref_pt = ber.BerPoint(4.0, n, k), ref.BerPoint(4.0, n, k)
        assert (pt.ber, pt.reliable) == (ref_pt.ber, ref_pt.reliable)
        assert pt.estimate(confidence, method) == got


def test_estimators_refuse_like_the_reference():
    from repro_torch.core import ber

    for call in (lambda: ber.wilson_interval(1, 0), lambda: ber.wilson_interval(5, 4),
                 lambda: ber.clopper_pearson(-1, 4), lambda: ber.zero_error_upper(0),
                 lambda: ber.rule_of_three(0), lambda: ber.estimate_ber(1, 4, method="wald")):
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("ebn0", [-2.0, 0.0, 3.5, 7.0])
def test_uncoded_theory_equals_the_reference(ebn0):
    from repro.core.ber import uncoded_ber_theory as ref_theory

    from repro_torch.core.ber import uncoded_ber_theory

    np.testing.assert_allclose(uncoded_ber_theory(ebn0), ref_theory(ebn0),
                               rtol=1e-12, atol=0)


def test_quantile_fallbacks_without_scipy_agree_with_scipy(monkeypatch):
    """Where scipy is absent the port computes its quantiles itself
    (Acklam's normal quantile, bisection on a continued-fraction
    incomplete beta): within 1e-8 relative of scipy's."""
    from scipy.special import betaincinv, ndtri

    from repro_torch.core import ber

    monkeypatch.setitem(sys.modules, "scipy.special", None)
    for q in (1e-6, 0.005, 0.025, 0.3, 0.5, 0.8, 0.975, 0.995):
        np.testing.assert_allclose(ber._norm_ppf(q), float(ndtri(q)), rtol=1e-8)
    for q, a, b in ((0.005, 1, 100), (0.995, 2, 99), (0.05, 34, 67),
                    (0.5, 3, 4096), (0.995, 4097, 1)):
        np.testing.assert_allclose(ber._beta_ppf(q, a, b),
                                   float(betaincinv(a, b, q)), rtol=1e-8)


# -- core/ber.py: the measurement ---------------------------------------------

@pytest.mark.parametrize("hard", [False, True])
def test_measure_ber_is_deterministic_from_its_seed(hard, monkeypatch):
    from repro_torch.core import CODE_K7_CCSDS, ber
    from repro_torch.core import channel as ch

    seen = []
    real = ch.hard_decision
    monkeypatch.setattr(ch, "hard_decision", lambda rx: seen.append(1) or real(rx))
    a = ber.measure_ber(CODE_K7_CCSDS, 3.0, 2048, _gen(4), hard=hard, device="cpu")
    b = ber.measure_ber(CODE_K7_CCSDS, 3.0, 2048, _gen(4), hard=hard, device="cpu")
    assert a == b and a.n_bits == 2048
    assert a.n_errors < 2048 * (0.05 if hard else 0.01)
    assert len(seen) == (2 if hard else 0)


def test_measure_ber_takes_a_decoder_and_ber_curve_falls_with_snr():
    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder, ber

    dec = ViterbiDecoder(CODE_K7_CCSDS, device="cpu")
    pt = ber.measure_ber(CODE_K7_CCSDS, 5.0, 1024, _gen(1), device="cpu",
                         decoder=dec.decode_stream_tiled)
    assert pt.n_errors == 0
    curve = ber.ber_curve(CODE_K7_CCSDS, [0.0, 1.0, 6.0], 8192, seed=3, device="cpu")
    again = ber.ber_curve(CODE_K7_CCSDS, [0.0, 1.0, 6.0], 8192, seed=3, device="cpu")
    assert curve == again
    assert curve[0].n_errors > curve[1].n_errors > curve[2].n_errors == 0


@pytest.mark.parametrize("entry", ["measure_ber", "measure_standard_ber"])
def test_ber_entry_points_default_to_the_kernel_wrappers(entry, monkeypatch):
    """By default the Monte-Carlo entry points decode through K1's
    wrapper (its plain version for these CPU tensors, the kernel on the
    card); ``use_kernel=False`` keeps them off it."""
    from repro_torch.codes import measure_standard_ber
    from repro_torch.core import CODE_K7_CCSDS, ber
    from repro_torch.kernels import ops

    calls = []
    real = ops.acs_forward
    monkeypatch.setattr(ops, "acs_forward",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def run(**kw):
        if entry == "measure_ber":
            return ber.measure_ber(CODE_K7_CCSDS, 6.0, 512, _gen(2), device="cpu", **kw)
        return measure_standard_ber("wifi-11a-r34", 6.0, 128, _gen(2), n_frames=2,
                                    device="cpu", **kw)[0]

    default = run()
    assert calls
    calls.clear()
    plain = run(use_kernel=False)
    assert not calls and plain == default


# -- codes/simulate.py ---------------------------------------------------------

@pytest.mark.parametrize("name", CODES)
def test_tx_frames_and_encode_standard_equal_the_reference(name):
    import jax.numpy as jnp
    from repro.codes import get_code as ref_get_code
    from repro.codes import simulate as ref

    from repro_torch.codes import get_code, simulate

    code, ref_code = get_code(name), ref_get_code(name)
    rng = np.random.default_rng(len(name))
    for rho in (1, 2, 3, 4):
        bits = rng.integers(0, 2, (3, 37 + rho))
        tx = simulate.tx_frames(torch.as_tensor(bits), code, rho=rho)
        want_tx = np.asarray(ref.tx_frames(jnp.asarray(bits), ref_code, rho=rho))
        np.testing.assert_array_equal(tx.numpy(), want_tx)
        if code.termination == "zero":
            assert tx.shape[1] % rho == 0
        else:
            np.testing.assert_array_equal(tx.numpy(), bits)
        np.testing.assert_array_equal(
            simulate.encode_standard(tx, code).numpy(),
            np.asarray(ref.encode_standard(jnp.asarray(want_tx), ref_code)),
        )


@pytest.mark.parametrize("name", ["wifi-11a-r34", "lte-tbcc", "gsm-cs1"])
def test_standard_llrs_are_the_llrs_of_the_awgn_at_the_effective_rate(name):
    import jax.numpy as jnp
    from repro.core import channel as ref_ch

    from repro_torch.codes import encode_standard, get_code, standard_llrs, tx_frames
    from repro_torch.core import channel as ch

    code = get_code(name)
    bits = torch.randint(0, 2, (2, 64), generator=_gen(0))
    coded = encode_standard(tx_frames(bits, code), code)
    got = standard_llrs(_gen(9), coded, 5.0, code)
    noise = torch.randn(coded.shape, generator=_gen(9))
    rx = ch.bpsk(coded) + ch.awgn_sigma(5.0, code.rate) * noise
    torch.testing.assert_close(got, ch.llr(rx, 5.0, code.rate), rtol=0, atol=0)
    want = ref_ch.llr(jnp.asarray(rx.numpy()), 5.0, code.rate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_count_errors_equals_the_reference():
    import jax.numpy as jnp
    from repro.codes.simulate import count_errors as ref_count

    from repro_torch.codes.simulate import count_errors

    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (5, 40))
    decoded = np.concatenate([bits, rng.integers(0, 2, (5, 6))], axis=1)
    decoded[1, 3] ^= 1
    decoded[3, [0, 39]] ^= 1
    got = count_errors(torch.as_tensor(decoded), torch.as_tensor(bits))
    want = ref_count(jnp.asarray(decoded), jnp.asarray(bits))
    assert [int(g) for g in got] == [int(w) for w in want] == [3, 2]
    assert all(g.dtype == torch.int32 for g in got)


def test_batch_keys_are_shard_invariant_and_stable_across_processes():
    from repro_torch.codes.simulate import batch_keys, point_key

    keys = batch_keys(7, "wifi-11a-r34", 4.5, 8)
    assert keys[:3] == batch_keys(7, "wifi-11a-r34", 4.5, 3)
    assert len(set(keys)) == 8 and all(0 <= k < 2**63 for k in keys)
    # a point measured in one batch draws what the farm's batch 0 draws
    assert point_key(7, "wifi-11a-r34", 4.5) == keys[0]
    others = {point_key(7, "wifi-11a-r34", 5.0), point_key(7, "lte-tbcc", 4.5),
              point_key(8, "wifi-11a-r34", 4.5), point_key(7, "wifi-11a-r34", 4.5)}
    assert len(others) == 4
    code = ("from repro_torch.codes.simulate import batch_keys, point_key\n"
            "print(batch_keys(7, 'wifi-11a-r34', 4.5, 8), "
            "point_key(7, 'wifi-11a-r34', 4.5))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), PYTHONHASHSEED="123")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.strip() == f"{keys} {point_key(7, 'wifi-11a-r34', 4.5)}"


def test_sim_frame_batch_is_the_standard_tx_chain():
    from repro_torch.codes import encode_standard, get_code, standard_llrs, tx_frames
    from repro_torch.codes.simulate import batch_keys, sim_frame_batch

    code = get_code("dvb-s-r78")
    seed = batch_keys(0, code.name, 6.0, 2)[1]
    bits, llrs = sim_frame_batch(_gen(seed), code, 3, 100, 6.0)
    g = _gen(seed)
    want_bits = torch.randint(0, 2, (3, 100), generator=g).to(torch.int32)
    want = standard_llrs(g, encode_standard(tx_frames(want_bits, code), code),
                         6.0, code)
    assert torch.equal(bits, want_bits) and torch.equal(llrs, want)
    assert llrs.shape == (3, code.puncture.punctured_len(106))


@pytest.mark.parametrize("name", ["wifi-11a-r34", "lte-tbcc", "dvb-s-r78"])
def test_measure_standard_ber_is_clean_at_6db(name):
    from repro_torch.codes import measure_standard_ber

    pt, dec = measure_standard_ber(name, 6.0 if name != "dvb-s-r78" else 7.0,
                                   512, _gen(11), n_frames=4, device="cpu")
    assert pt.n_errors == 0 and pt.n_bits == 2048
    again, _ = measure_standard_ber(name, 6.0, 512, _gen(11), n_frames=4, decoder=dec)
    assert again.n_bits == 2048


# -- data/pipeline.py: ChannelStream -------------------------------------------

def test_channel_stream_shards_draw_distinct_streams_and_resume():
    from repro_torch.data import ChannelStream

    s0 = ChannelStream(n_streams=2, stream_len=64, seed=1, device="cpu")
    s1 = s0.shard(1)
    b0, l0 = s0.batch_at(0)
    b1, l1 = s1.batch_at(0)
    assert not torch.equal(b0, b1) and not torch.equal(l0, l1)
    assert torch.equal(s0.batch_at(3)[1], s0.batch_at(3)[1])
    assert not torch.equal(s0.batch_at(3)[1], s0.batch_at(4)[1])
    assert len({s0.key_at(i) for i in range(4)} | {s1.key_at(i) for i in range(4)}) == 8
    it = iter(s1)
    assert torch.equal(next(it)[1], l1) and torch.equal(next(it)[1], s1.batch_at(1)[1])
    assert l0.shape == (2, 64, 2) and b0.dtype == torch.int32


def test_channel_stream_of_a_punctured_code_decodes_clean_at_6db():
    from repro_torch.core import ViterbiDecoder
    from repro_torch.data import ChannelStream

    stream = ChannelStream(n_streams=3, stream_len=600, ebn0_db=6.0,
                           code="wifi-11a-r34", seed=2, device="cpu")
    bits, llrs = stream.batch_at(0)
    assert llrs.shape == (3, 800)  # 600 stages at rate 3/4
    dec = ViterbiDecoder.from_standard("wifi-11a-r34", device="cpu")
    out = dec.decode_batch(llrs, initial_state=0)
    assert torch.equal(out, bits)


# -- the smoke modules ---------------------------------------------------------

def test_codes_smoke_runs_on_the_cpu(capsys):
    from repro_torch.codes import smoke

    smoke.main(device="cpu")
    out = capsys.readouterr().out
    assert "wifi-11a-r34 on cpu" in out and "lte-tbcc on cpu" in out


def test_soft_smoke_runs_on_the_cpu(capsys):
    from repro_torch.core import soft_smoke

    soft_smoke.main(device="cpu")
    out = capsys.readouterr().out
    assert out.count("sign(LLR) == viterbi") == 4
