"""The slice as a whole: ``repro_torch``'s ``ViterbiDecoder.decode_batch``
against ``repro``'s ``decode_batch(use_kernel=True)`` (interpret-mode K1
on the sequential path) and against the scalar oracle, on the
unpunctured zero-terminated registry codes and on the rate-1/3 LTE
mother code decoded with zero termination.

Frames are encoded with the reference convention (bit 0 -> +1, positive
LLR = bit 0) and tail-flushed; noise is made with numpy and handed to
both packages.  Bits must be identical everywhere.
"""
import numpy as np
import pytest
import torch

CODES = ["ccsds-k7", "dvb-s", "wifi-11a", "gsm-cs1"]


def _frames(spec, F, n_info, ebn0_db, seed):
    """(info bits (F, n_info), LLRs (F, n_info + k - 1, beta) float32)."""
    from repro_torch.core import conv_encode, tail_flush
    from repro_torch.core.channel import awgn_sigma

    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (F, n_info))
    coded = np.stack([conv_encode(tail_flush(b, spec), spec) for b in info])
    sigma = awgn_sigma(ebn0_db, spec.rate)
    y = (1.0 - 2.0 * coded) + sigma * rng.normal(size=coded.shape)
    return info, (2.0 * y / sigma**2).astype(np.float32)


def _ref_decode(spec, llrs, rho=2, **kw):
    from repro.core.decoder import ViterbiDecoder as RefDecoder
    from repro.core.trellis import CodeSpec as RefSpec

    dec = RefDecoder(RefSpec(k=spec.k, polys=spec.polys), rho=rho,
                     use_kernel=True, time_parallel=False)
    return np.asarray(dec.decode_batch(llrs, **kw))


def _oracle(spec, llrs, **kw):
    from repro_torch.core import viterbi_decode_ref

    return np.stack([viterbi_decode_ref(f, spec, **kw) for f in llrs])


@pytest.mark.parametrize("name", CODES)
def test_decode_batch_matches_reference_and_oracle(name):
    from repro_torch.codes import get_code
    from repro_torch.core import ViterbiDecoder

    spec = get_code(name).spec
    info, llrs = _frames(spec, 6, 58, 3.0, seed=len(name))
    ours = ViterbiDecoder.from_standard(name, device="cpu").decode_batch(llrs)
    assert ours.dtype == torch.int32 and ours.shape == llrs.shape[:2]
    ours = ours.numpy()
    np.testing.assert_array_equal(ours, _ref_decode(spec, llrs))
    np.testing.assert_array_equal(ours, _oracle(spec, llrs))
    # the noise is mild enough that the frames decode to what was sent
    assert (ours[:, :58] != info).mean() < 0.05


def test_lte_mother_code_with_zero_termination():
    from repro_torch.codes import get_code
    from repro_torch.core import ViterbiDecoder

    spec = get_code("lte-tbcc").spec
    _, llrs = _frames(spec, 5, 42, 1.0, seed=9)
    ours = ViterbiDecoder(spec, device="cpu").decode_batch(llrs).numpy()
    np.testing.assert_array_equal(ours, _ref_decode(spec, llrs))
    np.testing.assert_array_equal(ours, _oracle(spec, llrs))


@pytest.mark.parametrize(
    "rho,pack,final_state,precision",
    [
        (2, True, 0, "f32"),
        (1, False, None, "f32"),
        (2, False, None, "mm-bf16"),
        (2, True, None, "bf16-norenorm"),
    ],
)
def test_decode_batch_options_match_reference(rho, pack, final_state, precision):
    """Radix, survivor packing, a pinned final state and the reduced
    precisions, each as the reference decodes them."""
    import jax.numpy as jnp
    from repro.core.decoder import ViterbiDecoder as RefDecoder
    from repro.core.trellis import CODE_K7_CCSDS as REF_K7
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder
    from repro_torch.core.viterbi import AcsPrecision

    mm, carry, renorm = {
        "f32": ("f32", "f32", True),
        "mm-bf16": ("bf16", "f32", True),
        "bf16-norenorm": ("bf16", "bf16", False),
    }[precision]
    t = {"f32": torch.float32, "bf16": torch.bfloat16}
    j = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    _, llrs = _frames(CODE_K7_CCSDS, 4, 56, 1.5, seed=rho + 7 * pack)
    ours = ViterbiDecoder(
        CODE_K7_CCSDS, rho=rho, pack_survivors=pack, device="cpu",
        precision=AcsPrecision(t[mm], t[carry], renorm=renorm),
    ).decode_batch(llrs, final_state=final_state)
    ref = RefDecoder(
        REF_K7, rho=rho, pack_survivors=pack, use_kernel=True,
        time_parallel=False,
        precision=RefPrecision(j[mm], j[carry], renorm=renorm),
    ).decode_batch(llrs, final_state=final_state)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_plain_path_and_odd_lengths():
    """``use_kernel=False`` decodes as the kernel path does; n not a
    multiple of rho is zero-padded inside and cut back, and refuses a
    final-state pin that would land on the padding."""
    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder

    _, llrs = _frames(CODE_K7_CCSDS, 3, 50, 2.0, seed=3)
    llrs = llrs[:, :-1]  # 55 stages
    kernel = ViterbiDecoder(CODE_K7_CCSDS, device="cpu")
    plain = ViterbiDecoder(CODE_K7_CCSDS, use_kernel=False, device="cpu")
    ours = kernel.decode_batch(llrs)
    assert ours.shape == (3, 55)
    assert torch.equal(ours, plain.decode_batch(llrs))
    np.testing.assert_array_equal(ours.numpy(), _ref_decode(CODE_K7_CCSDS, llrs))
    with pytest.raises(ValueError, match="final_state"):
        kernel.decode_batch(llrs, final_state=0)


def test_inputs_are_validated_and_counted():
    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder
    from repro_torch.core.validate import InvalidInputError
    from repro_torch.obs import MetricsRegistry, set_default_registry

    dec = ViterbiDecoder(CODE_K7_CCSDS, device="cpu")
    _, llrs = _frames(CODE_K7_CCSDS, 2, 20, 3.0, seed=1)
    bad = llrs.copy()
    bad[1, 3, 0] = np.nan
    with pytest.raises(InvalidInputError) as info:
        dec.decode_batch(bad)
    assert info.value.reason == "non_finite"
    with pytest.raises(InvalidInputError, match="beta=2"):
        dec.decode_batch(llrs[..., :1])
    reg = MetricsRegistry()
    prev = set_default_registry(reg)
    try:
        sanitizing = ViterbiDecoder(CODE_K7_CCSDS, sanitize=True, device="cpu")
        out = sanitizing.decode_batch(bad)
        dec.decode_batch(llrs)
    finally:
        set_default_registry(prev)
    assert out.shape == (2, 26) and sanitizing.sanitized_total == 1
    assert reg.counter("decoder_dispatch_total").value(path="batch") == 2
    assert reg.counter("decoder_input_sanitized_total").total(reason="nan") == 1
