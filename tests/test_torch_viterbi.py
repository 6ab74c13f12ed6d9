"""``repro_torch.core.viterbi`` against ``repro.core.viterbi``: the plain
scan (``use_kernel=False``, split_dot honoured), the kernel contract
(``use_kernel=True``, run on the CPU through K1's plain version), the
traceback on int8 and packed survivors, and ``decode_frames``.

Integer-valued LLRs make every f32 sum exact in any order, so metrics,
survivors and bits must be bit-identical; Gaussian LLRs must give
identical bits and metrics within atol=1e-5, rtol=1e-6.
"""
import numpy as np
import pytest
import torch

PRECISIONS = {
    # name: (matmul, carry, renorm, split_dot)
    "f32": ("f32", "f32", True, False),
    "mm-bf16": ("bf16", "f32", True, False),
    "carry-bf16": ("f32", "bf16", True, False),
    "bf16-norenorm": ("bf16", "bf16", False, False),
    "split": ("bf16", "f32", False, True),
    "f32-norenorm-split": ("f32", "f32", False, True),
}


def _precisions(name):
    import jax.numpy as jnp
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core.viterbi import AcsPrecision

    mm, carry, renorm, split = PRECISIONS[name]
    t = {"f32": torch.float32, "bf16": torch.bfloat16}
    j = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    return (
        AcsPrecision(matmul_dtype=t[mm], carry_dtype=t[carry], renorm=renorm,
                     split_dot=split),
        RefPrecision(matmul_dtype=j[mm], carry_dtype=j[carry], renorm=renorm,
                     split_dot=split),
    )


def _llrs(F, n, beta, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:
        return rng.integers(-6, 7, (F, n, beta)).astype(np.float32)
    return rng.normal(0.0, 2.0, (F, n, beta)).astype(np.float32)


def _forward_both(llrs, rho, prec_name, use_kernel, pack, initial_state=0):
    import jax.numpy as jnp
    from repro.core.trellis import CODE_K7_CCSDS as REF_K7
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import blocks_from_llrs as ref_blocks
    from repro.core.viterbi import forward_fused as ref_forward
    from repro.core.viterbi import init_metric as ref_init

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables, forward_fused
    from repro_torch.core.viterbi import blocks_from_llrs, init_metric

    prec, ref_prec = _precisions(prec_name)
    F = llrs.shape[0]
    lam_r, phi_r = ref_forward(
        ref_blocks(jnp.asarray(llrs), rho), ref_init(F, 64, initial_state),
        ref_tables(REF_K7, rho), ref_prec, use_kernel, pack,
    )
    lam_p, phi_p = forward_fused(
        blocks_from_llrs(torch.from_numpy(llrs), rho),
        init_metric(F, 64, initial_state, "cpu"), build_acs_tables(CODE_K7_CCSDS, rho),
        prec, use_kernel, pack,
    )
    return (np.array(lam_r), np.array(phi_r)), (lam_p.numpy(), phi_p.numpy())


@pytest.mark.parametrize(
    "prec_name,pack",
    [("f32", False), ("f32", True), ("mm-bf16", True), ("carry-bf16", False),
     ("bf16-norenorm", True), ("split", False), ("f32-norenorm-split", True)],
)
def test_plain_scan_bit_identical_on_integer_llrs(prec_name, pack):
    llrs = _llrs(12, 64, 2, 1, True)
    (lam_r, phi_r), (lam_p, phi_p) = _forward_both(llrs, 2, prec_name, False, pack)
    np.testing.assert_array_equal(lam_p, lam_r)
    np.testing.assert_array_equal(phi_p, phi_r)


@pytest.mark.parametrize("prec_name", ["f32", "split", "carry-bf16"])
def test_kernel_contract_ignores_split_dot(prec_name):
    """``use_kernel=True`` is ``acs_forward_pallas``'s contract: blocks
    straight to the matmul dtype, split_dot ignored — on both sides."""
    llrs = _llrs(9, 48, 2, 2, True)
    (lam_r, phi_r), (lam_p, phi_p) = _forward_both(llrs, 2, prec_name, True, True)
    np.testing.assert_array_equal(lam_p, lam_r)
    np.testing.assert_array_equal(phi_p, phi_r)


@pytest.mark.parametrize("rho", [1, 2])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_forward_gaussian_llrs(use_kernel, rho):
    llrs = _llrs(16, 64, 2, 3, False)
    (lam_r, _), (lam_p, _) = _forward_both(
        llrs, rho, "f32", use_kernel, False, initial_state=None
    )
    np.testing.assert_allclose(lam_p, lam_r, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("rho", [1, 2])
def test_traceback_equals_reference(rho, pack):
    import jax.numpy as jnp
    from repro.core.trellis import CODE_K7_CCSDS as REF_K7
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import traceback_with_state as ref_traceback

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.viterbi import traceback, traceback_with_state

    llrs = _llrs(10, 48, 2, 4, False)
    (lam_r, phi_r), _ = _forward_both(llrs, rho, "f32", False, pack)
    fs = np.random.default_rng(0).integers(0, 64, 10)
    start_r, bits_r = ref_traceback(
        jnp.asarray(phi_r), jnp.asarray(fs), ref_tables(REF_K7, rho)
    )
    tb = build_acs_tables(CODE_K7_CCSDS, rho)
    start_p, bits_p = traceback_with_state(
        torch.from_numpy(phi_r), torch.from_numpy(fs), tb
    )
    assert bits_p.dtype == torch.int32 and bits_p.shape == (10, 48)
    np.testing.assert_array_equal(bits_p.numpy(), np.asarray(bits_r))
    np.testing.assert_array_equal(start_p.numpy(), np.asarray(start_r))
    assert torch.equal(traceback(torch.from_numpy(phi_r), torch.from_numpy(fs), tb), bits_p)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_decode_frames_equals_reference(use_kernel):
    import jax.numpy as jnp
    from repro.core.trellis import CodeSpec as RefSpec
    from repro.core.viterbi import decode_frames as ref_decode

    from repro_torch.core import CodeSpec, decode_frames

    spec = CodeSpec(k=5, polys=(0o23, 0o33))
    llrs = _llrs(8, 40, 2, 5, False)
    for s0, sf, pack in ((0, None, False), (None, None, True), (0, 0, True)):
        ref = ref_decode(jnp.asarray(llrs), RefSpec(k=5, polys=(0o23, 0o33)),
                         2, s0, sf, use_kernel=use_kernel, pack_survivors=pack)
        ours = decode_frames(llrs, spec, 2, s0, sf, use_kernel=use_kernel,
                             pack_survivors=pack, device="cpu")
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_precision_labels_and_headroom_match_reference():
    import jax.numpy as jnp
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core.viterbi import AcsPrecision

    pairs = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
             (torch.float16, jnp.float16)]
    for (mt, mj) in pairs:
        for (ct, cj) in pairs:
            for renorm in (True, False):
                for split in (False, True):
                    ours = AcsPrecision(mt, ct, mt, renorm, split)
                    ref = RefPrecision(mj, cj, mj, renorm, split)
                    assert ours.label() == ref.label()
                    assert ours.carry_mantissa_digits() == ref.carry_mantissa_digits()
                    assert ours.carry_absorb_limit() == ref.carry_absorb_limit()
                    assert ours.carry_max() == ref.carry_max()


def test_blocks_from_llrs_layout():
    from repro_torch.core.viterbi import blocks_from_llrs

    llrs = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
    blocks = blocks_from_llrs(llrs, 2)
    assert blocks.shape == (3, 2, 6)
    assert torch.equal(blocks[1, 1], llrs[1, 2:4].reshape(-1))
    with pytest.raises(ValueError, match="not divisible"):
        blocks_from_llrs(llrs[:, :5], 2)
