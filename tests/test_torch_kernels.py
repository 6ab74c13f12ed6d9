"""K1 (``repro_torch.kernels.viterbi_acs.acs_forward``), K2
(``acs_decode_fused``) and K3 (``transfer_matrix``), K1 and K3 also at
LOGPROB, against the reference's Pallas kernels (``repro.kernels.ops.viterbi_forward``,
``viterbi_decode_fused`` and ``viterbi_acs.transfer_matrix_pallas``),
which run in interpret mode on the CPU as the reference's own tests run
them.

On CPU tensors the wrappers run their plain versions, so these tests
hold the kernels' contracts; the CUDA kernels are held against the plain
versions on the card by the tests marked ``cuda`` and by
``chip_smoke.py``.

Tolerances: with integer-valued LLRs every f32 sum is exact in any
order, so Lambda and phi must be bit-identical.  With Gaussian LLRs the
sums round in the matmul's order: decoded bits must be identical and
Lambda must agree to atol=1e-5, rtol=1e-6; K3's matrices come out
bit-identical on Gaussian LLRs as well.

At LOGPROB the slot reduction is a logsumexp, whose exp and log round
differently in each library: K1's metrics and K3's matrices agree to
atol 1e-4 (the tolerance of the reference's soft tests) on reachable
entries, the -1e9 entries of unreachable ones are equal on both sides,
and K1's survivors are equal wherever the top two potentials differ by
more than 1e-3.  On the card, ``chip_smoke.py`` holds the CUDA LOGPROB
variants to their plain versions at a bound derived from f32 rounding.
"""
import math

import numpy as np
import pytest
import torch

DT = ("f32", "bf16")


def _dtypes(name):
    import jax.numpy as jnp

    return {"f32": (torch.float32, jnp.float32),
            "bf16": (torch.bfloat16, jnp.bfloat16)}[name]


def _inputs(spec, rho, F, T, seed, integer, initial_state):
    """(T, F, B) blocks and (F, S) start metrics, made with numpy."""
    from repro_torch.core.viterbi import NEG

    rng = np.random.default_rng(seed)
    B, S = rho * spec.beta, spec.n_states
    if integer:
        blocks = rng.integers(-8, 9, (T, F, B)).astype(np.float32)
    else:
        blocks = rng.normal(0.0, 2.0, (T, F, B)).astype(np.float32)
    lam0 = np.zeros((F, S), np.float32)
    if initial_state is not None:
        lam0[:] = NEG
        lam0[:, initial_state] = 0.0
    return blocks, lam0


def _run_pair(spec, rho, blocks, lam0, mm, carry, renorm, pack):
    """(reference lam, phi) via interpret-mode Pallas, (port lam, phi)
    via acs_forward on CPU tensors."""
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import AcsPrecision as RefPrecision
    from repro.kernels.ops import viterbi_forward as ref_forward

    from repro_torch.core.trellis import build_acs_tables
    from repro_torch.kernels import acs_forward

    mm_t, mm_j = _dtypes(mm)
    c_t, c_j = _dtypes(carry)
    prec = RefPrecision(matmul_dtype=mm_j, carry_dtype=c_j, renorm=renorm)
    lam_r, phi_r = ref_forward(
        jnp.asarray(blocks), jnp.asarray(lam0), ref_tables(spec, rho), prec,
        pack_survivors=pack,
    )
    tb = build_acs_tables(spec, rho)
    lam_p, phi_p = acs_forward(
        torch.from_numpy(blocks), torch.from_numpy(lam0),
        torch.from_numpy(tb.fused_w), n_states=tb.n_states,
        n_slots=tb.n_slots, carry_dtype=c_t, matmul_dtype=mm_t,
        renorm=renorm, pack_survivors=pack,
    )
    return (np.array(lam_r), np.array(phi_r)), (lam_p.numpy(), phi_p.numpy())


@pytest.mark.parametrize("pack", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize(
    "carry,renorm", [("f32", True), ("bf16", False)],
    ids=["cf32-renorm", "cbf16-norenorm"],
)
@pytest.mark.parametrize("mm", DT, ids=["mmf32", "mmbf16"])
def test_k1_bit_identical_on_integer_llrs(mm, carry, renorm, pack):
    from repro_torch.core import CODE_K7_CCSDS

    blocks, lam0 = _inputs(CODE_K7_CCSDS, 2, 16, 48, 1, True, 0)
    (lam_r, phi_r), (lam_p, phi_p) = _run_pair(
        CODE_K7_CCSDS, 2, blocks, lam0, mm, carry, renorm, pack
    )
    assert phi_p.dtype == phi_r.dtype and phi_p.shape == phi_r.shape
    np.testing.assert_array_equal(lam_p, lam_r)
    np.testing.assert_array_equal(phi_p, phi_r)


@pytest.mark.parametrize(
    "spec_name,rho,pack,initial_state",
    [
        ("ccsds-k7", 1, False, 0),
        ("ccsds-k7", 1, True, None),
        ("gsm-cs1", 2, True, 0),
        ("gsm-cs1", 1, False, None),
        ("lte-tbcc", 2, True, 0),
        ("ccsds-k7", 3, False, 0),
    ],
)
def test_k1_bit_identical_across_codes_and_radix(spec_name, rho, pack, initial_state):
    from repro_torch.codes import get_code

    spec = get_code(spec_name).spec
    blocks, lam0 = _inputs(spec, rho, 11, 40, 2, True, initial_state)
    (lam_r, phi_r), (lam_p, phi_p) = _run_pair(
        spec, rho, blocks, lam0, "f32", "f32", True, pack
    )
    np.testing.assert_array_equal(lam_p, lam_r)
    np.testing.assert_array_equal(phi_p, phi_r)


@pytest.mark.parametrize("mm", DT, ids=["mmf32", "mmbf16"])
@pytest.mark.parametrize("rho", [1, 2])
def test_k1_gaussian_llrs(rho, mm):
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import traceback as ref_traceback

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.viterbi import traceback

    blocks, lam0 = _inputs(CODE_K7_CCSDS, rho, 16, 64 // rho, 3, False, 0)
    (lam_r, phi_r), (lam_p, phi_p) = _run_pair(
        CODE_K7_CCSDS, rho, blocks, lam0, mm, "f32", True, False
    )
    np.testing.assert_allclose(lam_p, lam_r, atol=1e-5, rtol=1e-6)
    fs = lam_r.argmax(axis=-1)
    bits_r = ref_traceback(
        jnp.asarray(phi_r), jnp.asarray(fs), ref_tables(CODE_K7_CCSDS, rho)
    )
    bits_p = traceback(
        torch.from_numpy(phi_p), torch.from_numpy(fs),
        build_acs_tables(CODE_K7_CCSDS, rho),
    )
    np.testing.assert_array_equal(bits_p.numpy(), np.asarray(bits_r))


def test_k1_rejects_packing_it_cannot_hold():
    """The reference packs 16 slots of 3 bits into an int32 at rho=3 and
    corrupts them; K1 refuses, on every device, as it does S % 16."""
    from repro_torch.core import CODE_K7_CCSDS, CodeSpec, build_acs_tables
    from repro_torch.kernels import acs_forward, viterbi_forward

    tb = build_acs_tables(CODE_K7_CCSDS, 3)
    blocks, lam0 = torch.zeros(2, 3, tb.llr_block), torch.zeros(3, 64)
    with pytest.raises(ValueError, match="rho <= 2"):
        viterbi_forward(blocks, lam0, tb, pack_survivors=True)
    k3 = build_acs_tables(CodeSpec(k=3, polys=(7, 5)), 1)
    with pytest.raises(ValueError, match="n_states % 16"):
        acs_forward(
            torch.zeros(2, 3, 2), torch.zeros(3, 4),
            torch.as_tensor(k3.fused_w), n_states=4, n_slots=2,
            pack_survivors=True,
        )


def test_k1_ragged_and_empty_shapes():
    """Any F (no tile padding is visible to the caller); T = 0, which
    the reference's kernel cannot take, returns the start metrics
    through the carry cast and an empty survivor tensor."""
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import acs_forward

    for F, T in ((1, 5), (7, 9)):
        blocks, lam0 = _inputs(CODE_K7_CCSDS, 2, F, T, 4, True, None)
        (lam_r, phi_r), (lam_p, phi_p) = _run_pair(
            CODE_K7_CCSDS, 2, blocks, lam0, "f32", "bf16", True, True
        )
        np.testing.assert_array_equal(lam_p, lam_r)
        np.testing.assert_array_equal(phi_p, phi_r)
    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    lam0 = torch.linspace(-3.0, 3.0, 64).repeat(2, 1) / 7
    lam, phi = acs_forward(
        torch.zeros(0, 2, 4), lam0, torch.as_tensor(tb.fused_w),
        n_states=64, n_slots=4, carry_dtype=torch.bfloat16,
        pack_survivors=True,
    )
    assert torch.equal(lam, lam0.to(torch.bfloat16).float())
    assert phi.shape == (0, 2, 4) and phi.dtype == torch.int32


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card, bit for
    bit on integer LLRs, at ccsds-k7 rho=2 and at shapes the gathered
    kernel specialises on: gsm-cs1 (S=16, two frames a warp), rho=1 and
    3, a k=6 code (S=32, one state a lane) and a k=8 code (S=128, a frame
    over two warps); a W whose metric
    half is not the one-hot raises before any launch (needs an H100 and
    nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.codes import get_code
    from repro_torch.core import CODE_K7_CCSDS, CodeSpec, build_acs_tables
    from repro_torch.kernels import acs_forward
    from repro_torch.kernels.ref import acs_forward_ref

    dev = torch.device("cuda")
    cases = [(CODE_K7_CCSDS, 2, 40), (get_code("gsm-cs1").spec, 2, 37),
             (CODE_K7_CCSDS, 1, 37), (CODE_K7_CCSDS, 3, 37),
             (CodeSpec(k=6, polys=(0o53, 0o75)), 2, 37),
             (CodeSpec(k=8, polys=(0o371, 0o247)), 2, 9)]
    for spec, rho, F in cases:
        tb = build_acs_tables(spec, rho)
        blocks, lam0 = _inputs(spec, rho, F, 100, 5, True, 0)
        w = torch.as_tensor(tb.fused_w, device=dev)
        args = (torch.from_numpy(blocks).to(dev), torch.from_numpy(lam0).to(dev), w)
        for mm in (torch.float32, torch.bfloat16):
            for pack in (False, True):
                if pack and (tb.n_states % 16 or tb.n_slots > 4):
                    continue
                kw = dict(n_states=tb.n_states, n_slots=tb.n_slots,
                          matmul_dtype=mm, pack_survivors=pack)
                lam_k, phi_k = acs_forward(*args, **kw)
                lam_r, phi_r = acs_forward_ref(*args, **kw)
                torch.cuda.synchronize()
                assert torch.equal(lam_k, lam_r) and torch.equal(phi_k, phi_r)
    broken = w.clone()
    broken[tb.llr_block:] = broken[tb.llr_block:].roll(1, dims=0)
    before = acs_forward.launches
    with pytest.raises(ValueError, match="other predecessors"):
        acs_forward(args[0], args[1], broken, n_states=tb.n_states,
                    n_slots=tb.n_slots)
    assert acs_forward.launches == before


# -- K2: the one-pass time-tiled decode ---------------------------------

def _k2_inputs(F, T, D, pack, seed):
    """Integer (T, F, 4) blocks, a one-hot start metric and an entry ring
    of random survivors (whole int32 words when packed)."""
    from repro_torch.core.viterbi import NEG

    rng = np.random.default_rng(seed)
    blocks = rng.integers(-8, 9, (T, F, 4)).astype(np.float32)
    lam0 = np.full((F, 64), NEG, np.float32)
    lam0[:, 0] = 0.0
    if pack:
        hist0 = rng.integers(-2**31, 2**31, (D, F, 4)).astype(np.int32)
    else:
        hist0 = rng.integers(0, 4, (D, F, 64)).astype(np.int8)
    return blocks, lam0, hist0


@pytest.mark.parametrize("depth_tiles", [2, 4])
@pytest.mark.parametrize("pack", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("renorm", [True, False], ids=["renorm", "raw"])
@pytest.mark.parametrize("mm", DT, ids=["mmf32", "mmbf16"])
def test_k2_bit_identical_to_reference(mm, renorm, pack, depth_tiles):
    """bits, exit metrics and exit ring, with an entry ring carried in."""
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import AcsPrecision as RefPrecision
    from repro.kernels.ops import viterbi_decode_fused as ref_fused

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.viterbi import AcsPrecision
    from repro_torch.kernels import viterbi_decode_fused

    TT = 8
    blocks, lam0, hist0 = _k2_inputs(5, 4 * TT, depth_tiles * TT, pack, 7)
    mm_t, mm_j = _dtypes(mm)
    ref = ref_fused(
        jnp.asarray(blocks), jnp.asarray(lam0), jnp.asarray(hist0),
        ref_tables(_ref_spec(CODE_K7_CCSDS), 2),
        RefPrecision(matmul_dtype=mm_j, renorm=renorm),
        time_tile=TT, pack_survivors=pack,
    )
    got = viterbi_decode_fused(
        torch.from_numpy(blocks), torch.from_numpy(lam0),
        torch.from_numpy(hist0), build_acs_tables(CODE_K7_CCSDS, 2),
        AcsPrecision(matmul_dtype=mm_t, renorm=renorm),
        time_tile=TT, pack_survivors=pack,
    )
    for r, g in zip(ref, got):
        assert g.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[np.asarray(r).dtype]
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _ref_spec(spec):
    from repro.core.trellis import CodeSpec as RefSpec

    return RefSpec(k=spec.k, polys=spec.polys)


def test_k2_refuses_what_the_reference_refuses():
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import acs_decode_fused

    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    w = torch.as_tensor(tb.fused_w)
    kw = dict(n_states=64, n_slots=4, k=7, rho=2, time_tile=8)
    blocks, lam0 = torch.zeros(24, 3, 4), torch.zeros(3, 64)
    ring8 = torch.zeros(16, 3, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="not divisible by time_tile"):
        acs_decode_fused(blocks[:20], lam0, ring8, w, **kw)
    with pytest.raises(ValueError, match="depth D=12"):
        acs_decode_fused(blocks, lam0, ring8[:12], w, **kw)
    with pytest.raises(ValueError, match="does not match"):
        acs_decode_fused(blocks, lam0, ring8, w, pack_survivors=True, **kw)
    with pytest.raises(ValueError, match="does not match"):
        acs_decode_fused(blocks, lam0, ring8.to(torch.int32), w, **kw)
    with pytest.raises(ValueError, match="at least one step"):
        acs_decode_fused(blocks[:0], lam0, ring8, w, **kw)
    tb3 = build_acs_tables(CODE_K7_CCSDS, 3)
    with pytest.raises(ValueError, match="rho <= 2"):
        acs_decode_fused(
            torch.zeros(8, 3, 6), lam0, torch.zeros(8, 3, 4, dtype=torch.int32),
            torch.as_tensor(tb3.fused_w), n_states=64, n_slots=8, k=7, rho=3,
            time_tile=8, pack_survivors=True,
        )
    # a tile longer than the call is cut to the call, as in the reference
    bits, lam, hist = acs_decode_fused(blocks[:8], lam0, ring8, w, **dict(kw, time_tile=32))
    assert bits.shape == (16, 3) and lam.shape == (3, 64) and hist.shape == ring8.shape


@pytest.mark.parametrize("n_states,pack,depth,tile,frames,want", [
    (64, True, 2560, 32, 512, (4, True)),  # the streaming geometry: one wave
    (64, True, 256, 32, 512, (4, True)),
    (64, False, 256, 32, 512, (4, True)),
    # 171 KB a frame: one frame a block is four waves at F=512, so the
    # rings go to device memory at four a block (one wave); at F=64 one
    # frame a block is one wave too, and shared memory keeps them
    (64, False, 2560, 32, 512, (4, False)),
    (64, False, 2560, 32, 64, (1, True)),
    (64, True, 30720, 32, 512, (4, False)),  # no frame fits: rings in HBM
    (64, True, 2560, 1, 512, (4, False)),  # a map a step: 1 frame fits
    (64, True, 2560, 1, 132, (1, True)),
    (16, True, 256, 32, 512, (8, True)),  # two 16-state frames a warp
    (16, True, 20000, 32, 512, (8, False)),  # 2 fit: 2 waves against 1
    (16, True, 20000, 32, 128, (2, True)),
    (16, True, 60000, 32, 512, (8, False)),
    (128, False, 256, 32, 512, (1, True)),  # a frame over two warps
    (2, False, 512, 1, 130, (48, True)),  # three warps of 16 frames fit
])
def test_k2_block_frames(n_states, pack, depth, tile, frames, want):
    """K2's block: the most whole frame groups (warps, up to four) whose
    rings and tile maps fit in shared memory beside their staging, unless
    the rings in device memory at four groups take fewer waves of the
    call's frames; W is not in shared memory (a group's staging at
    ccsds-k7, rho=2: 5,504 bytes), and the walk warp beside the groups
    needs none of its own but the frames' start states, two buffers of
    them."""
    from repro_torch.core.kernel_geometry import (
        GATHER_WARPS, SMEM_LIMIT_BYTES, gather_group_bytes,
        gather_group_frames, k2_block_frames, k2_frame_bytes, k2_smem_bytes,
        k2_waves,
    )

    B, n_cols = 4, 16
    bf, in_smem = k2_block_frames(n_states, B, n_cols, depth, tile, pack, frames)
    assert (bf, in_smem) == want
    gf = gather_group_frames(n_states)
    assert bf % gf == 0 and bf <= GATHER_WARPS * gf
    smem = k2_smem_bytes(n_states, B, n_cols, depth, tile, pack, bf, in_smem)
    assert smem <= SMEM_LIMIT_BYTES
    hbm = (GATHER_WARPS if n_states <= 64 else 1) * gf  # a frame over warps: one
    fit = [f for f in range(gf, hbm + 1, gf) if k2_smem_bytes(
        n_states, B, n_cols, depth, tile, pack, f, True) <= SMEM_LIMIT_BYTES]
    if in_smem:
        assert bf == max(fit)
        assert k2_waves(frames, n_states, bf, smem) <= k2_waves(
            frames, n_states, hbm, k2_smem_bytes(n_states, B, n_cols, depth, tile, pack,
                                                 hbm, False))
    elif fit:  # shared memory would take more waves
        assert k2_waves(frames, n_states, max(fit), k2_smem_bytes(
            n_states, B, n_cols, depth, tile, pack, max(fit), True)) > k2_waves(
            frames, n_states, bf, smem)
    assert gather_group_bytes(64, 4, 16, 32, True) == 5504
    # the ring holds D + 2 TT steps and as many tile maps (the walk warp
    # walks tile jt while the ACS writes tile jt + 1)
    assert k2_frame_bytes(64, 2560, 32, True) == 2624 * 16 + 82 * 64
    assert k2_smem_bytes(64, 4, 16, 2560, 32, True, 4, True) == 4 * 5504 + 32 + 4 * 47232


@pytest.mark.parametrize("frames,block_frames,smem,n_states,n_sms,want", [
    (512, 4, 210976, 64, 132, 1),  # one block an SM: 128 blocks
    (512, 1, 200000, 64, 132, 4),  # 512 blocks of one frame
    (512, 4, 22048, 64, 132, 1),  # three blocks an SM (launch bounds)
    (8192, 4, 22048, 64, 132, 6),  # 2048 blocks over 396 places
    (8192, 4, 22048, 64, 66, 11),  # half the SMs
    (600, 1, 100000, 128, 132, 5),  # a wide frame: one block an SM
])
def test_k2_waves(frames, block_frames, smem, n_states, n_sms, want):
    """Waves of K2 blocks, counting the blocks an SM surely holds: as
    many as its 228 KiB of shared memory take (1 KiB reserved a block),
    and at most the launch bounds' three (one for a frame over warps)."""
    from repro_torch.core.kernel_geometry import k2_waves

    assert k2_waves(frames, n_states, block_frames, smem, n_sms) == want


def test_streaming_geometry_is_one_wave():
    """At the geometry decode_stream_chunked launches K2 with (ccsds-k7,
    S=64, R=4, D=2560 steps, TT=32, packed ring, F=512 frames) a block
    holds four frames with their rings in shared memory, so the grid is
    128 blocks: one wave on the H100's 132 SMs, one block an SM."""
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.kernel_geometry import (
        SMEM_LIMIT_BYTES, gather_block_shape, k2_block_frames, k2_smem_bytes,
    )
    from repro_torch.kernels.viterbi_acs import gather_operands

    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    n_cols = gather_operands(torch.from_numpy(tb.fused_w), 4, 64, 4).cols.shape[1]
    assert n_cols == 16
    bf, in_smem = k2_block_frames(64, 4, n_cols, 2560, 32, True, 512)
    assert (bf, in_smem) == (4, True)
    assert gather_block_shape(64) == (4, 128)
    assert -(-512 // bf) == 128 <= 132
    smem = k2_smem_bytes(64, 4, n_cols, 2560, 32, True, bf, in_smem)
    assert smem == 210976 <= SMEM_LIMIT_BYTES
    assert 2 * smem > SMEM_LIMIT_BYTES  # one block an SM


@pytest.mark.parametrize("n_states,frames,threads,nq", [
    (2, 64, 128, 1), (4, 32, 128, 1), (16, 8, 128, 1), (32, 4, 128, 1),
    (64, 4, 128, 2), (128, 1, 64, 2), (512, 1, 256, 2), (1024, 1, 512, 2),
])
def test_gather_block_shape(n_states, frames, threads, nq):
    """K1's and K2's block: a frame over S/NQ threads (NQ = 2 from S=64),
    four warps of frames where a frame fits in a warp, else one frame of
    S/2 threads; S above 1024 raises."""
    from repro_torch.core.kernel_geometry import (
        gather_block_shape, gather_frame_threads, gather_states_per_thread,
    )

    assert gather_block_shape(n_states) == (frames, threads)
    assert gather_states_per_thread(n_states) == nq
    assert gather_frame_threads(n_states) * nq == n_states
    with pytest.raises(ValueError, match="at most 1024"):
        gather_frame_threads(2048)


@pytest.mark.parametrize("n_states,llr_block,n_cols,stage,smem", [
    (64, 4, 16, 32, 4 * 5248),  # ccsds-k7, rho=2
    (16, 4, 16, 32, 4 * 6528),
    (128, 4, 16, 32, 7808),
    (64, 12, 1024, 8, 4 * 34304),  # lte-tbcc, rho=4: stages cut to 8 steps
    (1024, 16, 16384, 1, 74944),  # every column distinct: one step a stage
])
def test_k1_smem_bytes(n_states, llr_block, n_cols, stage, smem):
    """K1's shared memory, at both semirings: its frame groups' staging (LLRs,
    branch metrics of the distinct columns, metrics double-buffered,
    survivors) at stages of up to 32 steps, cut while a group's region
    passes GATHER_GROUP_BUDGET; W is not in shared memory."""
    from repro_torch.core.kernel_geometry import (
        GATHER_GROUP_BUDGET, SMEM_LIMIT_BYTES, gather_group_bytes,
        gather_stage_steps, k1_smem_bytes,
    )

    ss = gather_stage_steps(n_states, llr_block, n_cols, False)
    assert ss == stage
    assert k1_smem_bytes(n_states, llr_block, n_cols) == smem <= SMEM_LIMIT_BYTES
    if ss > 1:
        assert gather_group_bytes(n_states, llr_block, n_cols, ss, False) <= GATHER_GROUP_BUDGET
    if ss < 32:
        assert gather_group_bytes(n_states, llr_block, n_cols, 2 * ss, False) > GATHER_GROUP_BUDGET


@pytest.mark.cuda
def test_cuda_k2_matches_plain():
    """K2 against its plain version on the card, bit for bit on integer
    LLRs, with the ring in shared memory and in device memory, at the
    streaming path's geometry (the default depth of 2560 steps, packed,
    F=512: four frames a block, 128 blocks) and at shapes the gathered
    kernel specialises on: gsm-cs1 (S=16), rho=1 and 3, a k=8 code
    (S=128), T=TT and TT=1, and 32 or 64 frames a block (S=4, S=2) at
    TT=1 under a window of 512 steps; a W whose metric half is not the
    one-hot raises before any launch (needs an H100 and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.codes import get_code
    from repro_torch.core import CODE_K7_CCSDS, CodeSpec, build_acs_tables
    from repro_torch.kernels import acs_decode_fused
    from repro_torch.kernels.ref import acs_decode_fused_ref

    dev = torch.device("cuda")
    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w, device=dev)
    for F, D, pack in ((37, 64, True), (37, 64, False), (9, 2560, False),
                       (512, 2560, True)):
        blocks, lam0, hist0 = _k2_inputs(F, 128, D, pack, 8)
        args = [torch.from_numpy(x).to(dev) for x in (blocks, lam0, hist0)]
        kw = dict(n_states=64, n_slots=4, k=7, rho=2, time_tile=32,
                  pack_survivors=pack)
        got = acs_decode_fused(*args, w, **kw)
        want = acs_decode_fused_ref(*args, w, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, want))
    rng = np.random.default_rng(9)
    for spec, rho, T, TT, D in ((get_code("gsm-cs1").spec, 2, 64, 16, 32),
                                (CODE_K7_CCSDS, 1, 64, 16, 32),
                                (CODE_K7_CCSDS, 3, 16, 16, 48),
                                (CODE_K7_CCSDS, 2, 8, 1, 5),
                                (CodeSpec(k=8, polys=(0o371, 0o247)), 2, 32, 8, 16)):
        tb = build_acs_tables(spec, rho)
        S, R, B = tb.n_states, tb.n_slots, tb.llr_block
        wc = torch.as_tensor(tb.fused_w, device=dev)
        for pack in (False, True):
            if pack and (S % 16 or R > 4):
                continue
            F = 13
            blocks = torch.from_numpy(rng.integers(-3, 4, (T, F, B)).astype(np.float32)).to(dev)
            lam0 = torch.zeros((F, S), device=dev)
            if pack:
                hist0 = rng.integers(-2**31, 2**31, (D, F, S // 16)).astype(np.int32)
            else:
                hist0 = rng.integers(0, R, (D, F, S)).astype(np.int8)
            hist0 = torch.from_numpy(hist0).to(dev)
            kw = dict(n_states=S, n_slots=R, k=spec.k, rho=rho, time_tile=TT,
                      pack_survivors=pack)
            got = acs_decode_fused(blocks, lam0, hist0, wc, **kw)
            want = acs_decode_fused_ref(blocks, lam0, hist0, wc, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(g, r) for g, r in zip(got, want)), (spec, rho, TT, pack)
    # 64 frames a block (S=2, two a lane of the walk warp) and 32 (S=4),
    # tiles of one step under a deep window: the walk of a tile outlasts
    # the next tile's ACS
    for k, polys in ((2, (0o3, 0o1)), (3, (0o7, 0o5))):
        small, kw = _map_walk_case(CodeSpec(k=k, polys=polys), 1, 130, 48, 1, 512, False, k)
        small = [x.to(dev) for x in small]
        got = acs_decode_fused(*small, **kw)
        want = acs_decode_fused_ref(*small, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(g, r) for g, r in zip(got, want)), (k, "TT=1")
    broken = w.clone()
    broken[4:] = broken[4:] * 2.0
    before = acs_decode_fused.launches
    with pytest.raises(ValueError, match="one 1.0 per column"):
        acs_decode_fused(*args, broken, n_states=64, n_slots=4, k=7, rho=2,
                         time_tile=32, pack_survivors=True)
    assert acs_decode_fused.launches == before


# -- K3: the transfer-matrix formation ----------------------------------

def _k3_run_pair(blocks, mm, carry, split, transfer_tile):
    """(reference M via the interpret-mode Pallas K3, port M via
    ``transfer_matrix`` on CPU tensors)."""
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.kernels.viterbi_acs import transfer_matrix_pallas

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import transfer_matrix

    mm_t, mm_j = _dtypes(mm)
    c_t, c_j = _dtypes(carry)
    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    ref = transfer_matrix_pallas(
        jnp.asarray(blocks), jnp.asarray(ref_tables(_ref_spec(CODE_K7_CCSDS), 2).fused_w),
        n_states=64, n_slots=4, transfer_tile=transfer_tile,
        carry_dtype=c_j, matmul_dtype=mm_j, split_dot=split, interpret=True,
    )
    got = transfer_matrix(
        torch.from_numpy(blocks), torch.from_numpy(tb.fused_w), n_states=64,
        n_slots=4, transfer_tile=transfer_tile, carry_dtype=c_t,
        matmul_dtype=mm_t, split_dot=split,
    )
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("carry", DT, ids=["cf32", "cbf16"])
@pytest.mark.parametrize("mm", DT, ids=["mmf32", "mmbf16"])
def test_k3_bit_identical_on_integer_llrs(mm, carry, split):
    """K3's plain version against the reference's Pallas K3 in interpret
    mode: M bit for bit on integer LLRs, over the precision policies,
    with a frame count (5) that is not a multiple of either block."""
    blocks, _ = _inputs(_spec_k7(), 2, 5, 32, 11, True, None)
    ref, got = _k3_run_pair(blocks, mm, carry, split, 8)
    assert got.shape == ref.shape == (4, 5, 64, 64) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_k3_gaussian_llrs():
    """On Gaussian LLRs the B LLR terms of a potential are summed in the
    same order by both, so M is bit-identical here too."""
    blocks, _ = _inputs(_spec_k7(), 2, 3, 64, 12, False, None)
    ref, got = _k3_run_pair(blocks, "f32", "f32", False, 16)
    np.testing.assert_array_equal(got, ref)


def _spec_k7():
    from repro_torch.core import CODE_K7_CCSDS

    return CODE_K7_CCSDS


@pytest.mark.parametrize("n_states,n_slots,frames,period,stage,regs,smem", [
    (64, 4, 2, 3, 9, True, 36880),  # ccsds-k7, rho=2: 2 x 9 steps x 2 frames x 1 KiB
    (64, 2, 2, 6, 12, True, 24592),
    (64, 8, 2, 2, 8, True, 65552),
    (16, 4, 8, 2, 8, True, 32800),
    (64, 16, 2, 3, 9, False, 180752),  # + 128 rows of 65 floats
    (16, 16, 8, 1, 8, False, 139808),
    (32, 4, 4, 5, 10, False, 57872),
    (2, 2, 64, 1, 8, False, 18176),
])
def test_k3_block_frames(n_states, n_slots, frames, period, stage, regs, smem):
    """K3's geometry: one thread per (frame, entry row) in blocks of 128,
    the rotation period (k-1)/gcd(k-1, rho) of the register map, stages
    of a whole number of periods, rows in registers at S in {16, 64} and
    R <= 8, and the double-buffered branch-metric table, the rows kept in
    shared memory elsewhere and the final shift's warp maxima, within a
    block's shared memory."""
    from repro_torch.core.kernel_geometry import (
        K3_THREADS, SMEM_LIMIT_BYTES, k3_block_frames, k3_in_registers,
        k3_rotation_period, k3_smem_bytes, k3_stage_steps,
    )

    bf = k3_block_frames(n_states)
    assert bf == frames and bf * n_states == K3_THREADS
    assert k3_rotation_period(n_states, n_slots) == period
    assert k3_stage_steps(n_states, n_slots) == stage and stage % period == 0
    assert k3_in_registers(n_states, n_slots) == regs
    assert k3_smem_bytes(n_states, n_slots) == smem <= SMEM_LIMIT_BYTES


REGISTRY_CODES = ("ccsds-k7", "dvb-s", "dvb-s-r78", "gsm-cs1", "lte-tbcc",
                  "wifi-11a", "wifi-11a-r23", "wifi-11a-r34", "wifi-11a-r56")


@pytest.mark.parametrize("rho", [1, 2, 3, 4])
@pytest.mark.parametrize("code", REGISTRY_CODES)
def test_k3_gather_tables_match_the_trellis(code, rho):
    """The tables the gathered kernels' wrappers (K1, K2, K3)
    derive from W, ``kernel_geometry.gather_tables``: its LLR half and
    each column's predecessor are the trellis's own, for every registry
    code and radix."""
    from repro_torch.codes import get_code, list_codes
    from repro_torch.core import build_acs_tables
    from repro_torch.core.kernel_geometry import gather_tables

    assert tuple(list_codes()) == REGISTRY_CODES
    tb = build_acs_tables(get_code(code).spec, rho)
    theta, pred = gather_tables(torch.from_numpy(tb.fused_w),
                                tb.llr_block, tb.n_states, tb.n_slots)
    np.testing.assert_array_equal(theta.numpy(), tb.theta_t)
    np.testing.assert_array_equal(pred.numpy(), tb.pred_state)


def _permute_columns(p):
    return p[:, [1, 0] + list(range(2, p.shape[1]))]


def _second_one(p):
    p = p.clone()
    p[0, :] = 1.0
    return p


@pytest.mark.parametrize("broken,match", [
    (_permute_columns, "other predecessors"),
    (lambda p: p * 2.0, "one 1.0 per column"),
    (_second_one, "one 1.0 per column"),
    (lambda p: p.roll(1, dims=0), "other predecessors"),
], ids=["permuted", "scaled", "two-ones", "rows-rolled"])
def test_k3_gather_tables_refuse_another_routing(broken, match):
    """A W whose metric half is not the shift register's one-hot raises
    ValueError in ``gather_tables`` and in ``gather_operands``, which K1
    (tropical), K2 and K3 call before any launch (none has a dense
    path)."""
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.kernel_geometry import gather_tables
    from repro_torch.kernels.viterbi_acs import gather_operands

    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    w = torch.from_numpy(tb.fused_w).clone()
    w[4:] = broken(w[4:])
    with pytest.raises(ValueError, match=match):
        gather_tables(w, 4, 64, 4)
    with pytest.raises(ValueError, match=match):
        gather_operands(w, 4, 64, 4)
    with pytest.raises(ValueError, match="expected"):
        gather_tables(w[:-1], 4, 64, 4)
    with pytest.raises(ValueError, match="R = 2"):
        gather_tables(w, 4, 48, 4)


@pytest.mark.parametrize("rho", [1, 2, 3, 4])
@pytest.mark.parametrize("code", ["ccsds-k7", "gsm-cs1", "lte-tbcc", "wifi-11a-r34"])
def test_gather_operands_for_k1_and_k2(code, rho):
    """What the K1 and K2 wrappers take in place of W, made once per
    tables by ``ops.device_tables``: Theta's distinct columns (at most
    2^B of them) and each column's index among them, which give back
    Theta exactly; the same W and operands come back for the same tables
    (so a stream's launches read no W on the host), and a W changed in
    place is read afresh by ``gather_operands``, which then refuses it."""
    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables
    from repro_torch.kernels import ops
    from repro_torch.kernels.viterbi_acs import gather_operands

    tb = build_acs_tables(get_code(code).spec, rho)
    B, S, R = tb.llr_block, tb.n_states, tb.n_slots
    w, got = ops.device_tables(tb, torch.device("cpu"))
    again = ops.device_tables(tb, torch.device("cpu"))
    assert again[0] is w and again[1] is got
    np.testing.assert_array_equal(w.numpy(), tb.fused_w)
    assert got.cols.dtype == torch.float32 and got.cid.dtype == torch.int16
    n_cols = got.cols.shape[1]
    assert got.cols.shape == (B, n_cols) and got.cid.shape == (S * R,)
    assert n_cols <= min(2 ** B, S * R)
    assert torch.unique(got.cols.T, dim=0).shape[0] == n_cols
    np.testing.assert_array_equal(got.cols[:, got.cid.long()].numpy(), tb.theta_t)
    for a, b in zip(gather_operands(w, B, S, R), got):
        assert torch.equal(a, b)
    w2 = w.clone()
    w2[B:] = w2[B:].roll(1, dims=0)
    with pytest.raises(ValueError, match="other predecessors"):
        gather_operands(w2, B, S, R)


def test_wrappers_check_the_operands_they_are_given():
    """Operands made for another shape of W are refused before any
    launch, so a caller's stale operands cannot index past the kernel's
    tables."""
    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables
    from repro_torch.kernels import ops
    from repro_torch.kernels.viterbi_acs import _operands

    w2, ops2 = ops.device_tables(build_acs_tables(get_code("ccsds-k7").spec, 2),
                                 torch.device("cpu"))
    w3, ops3 = ops.device_tables(build_acs_tables(get_code("ccsds-k7").spec, 3),
                                 torch.device("cpu"))
    assert _operands("k", w2, ops2, 4, 64, 4) is ops2
    with pytest.raises(ValueError, match="operands do not fit"):
        _operands("k", w2, ops3, 4, 64, 4)
    with pytest.raises(ValueError, match="operands do not fit"):
        _operands("k", w3, ops2, 6, 64, 8)


def _map_walk_case(spec, rho, F, T, TT, D, pack, seed):
    from repro_torch.core import build_acs_tables

    rng = np.random.default_rng(seed)
    tb = build_acs_tables(spec, rho)
    S, R, B = tb.n_states, tb.n_slots, tb.llr_block
    blocks = torch.from_numpy(rng.integers(-2, 3, (T, F, B)).astype(np.float32))
    lam0 = torch.from_numpy(rng.integers(-2, 1, (F, S)).astype(np.float32))
    if pack:
        hist0 = rng.integers(-2**31, 2**31, (D, F, S // 16)).astype(np.int32)
    else:
        hist0 = rng.integers(0, R, (D, F, S)).astype(np.int8)
    kw = dict(n_states=S, n_slots=R, k=spec.k, rho=rho, time_tile=TT,
              pack_survivors=pack)
    return (blocks, lam0, torch.from_numpy(hist0), torch.from_numpy(tb.fused_w)), kw


@pytest.mark.parametrize("tt_d", [(1, 3), (4, 8), (8, 8), (2, 0), (4, 16)],
                         ids=lambda c: f"TT{c[0]}-D{c[1]}")
@pytest.mark.parametrize("code,rho,pack", [
    (code, rho, pack) for code in ("ccsds-k7", "gsm-cs1") for rho in (1, 2, 3, 4)
    for pack in (False, True) if not pack or rho <= 2  # packed: 16 slots a word
])
def test_map_walk_model_matches_plain_k2(code, rho, pack, tt_d):
    """K2's walk through per-tile state maps (``acs_decode_fused_maps_ref``,
    the model of csrc/acs_decode_fused.cu's walk) emits the bits, metrics
    and exit ring of the plain version's straight walk, on integer LLRs
    in -2..2 (ties everywhere), with a random entry ring, at every radix,
    packed and int8 rings, several D/TT, and F=5 frames."""
    from repro_torch.codes import get_code
    from repro_torch.kernels.ref import acs_decode_fused_maps_ref, acs_decode_fused_ref

    spec = get_code(code).spec
    TT, D = tt_d
    args, kw = _map_walk_case(spec, rho, 5, 3 * TT, TT, D, pack, 10 * rho + TT)
    want = acs_decode_fused_ref(*args, **kw)
    got = acs_decode_fused_maps_ref(*args, **kw)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("k,polys", [(2, (0o3, 0o1)), (3, (0o7, 0o5))], ids=["S2", "S4"])
def test_map_walk_model_small_trellis_deep_window(k, polys):
    """The map walk where a K2 block holds 64 frames (S=2, two a lane of
    the walk warp) or 32 (S=4), under tiles of one step and a window of
    512 steps, over F=130 frames: the bits, metrics and exit ring of the
    plain version's straight walk (``test_cuda_k2_matches_plain`` and
    ``chip_smoke.py`` hold the kernel to it at this shape)."""
    from repro_torch.core import CodeSpec
    from repro_torch.kernels.ref import acs_decode_fused_maps_ref, acs_decode_fused_ref

    args, kw = _map_walk_case(CodeSpec(k=k, polys=polys), 1, 130, 48, 1, 512, False, k)
    want = acs_decode_fused_ref(*args, **kw)
    got = acs_decode_fused_maps_ref(*args, **kw)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


def test_k3_refuses_what_it_cannot_hold():
    """A shape that fits at no frame count raises ValueError, as in the
    reference; so do a ragged tile grid and an unknown semiring."""
    from repro_torch.core import CODE_K7_CCSDS, CodeSpec, build_acs_tables
    from repro_torch.kernels import transfer_matrix

    k9 = build_acs_tables(CodeSpec(k=9, polys=(0o561, 0o753)), 2)
    with pytest.raises(ValueError, match="do not fit"):
        transfer_matrix(
            torch.zeros(8, 2, 4), torch.as_tensor(k9.fused_w),
            n_states=256, n_slots=4, transfer_tile=4,
        )
    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w)
    with pytest.raises(ValueError, match="not divisible by transfer_tile"):
        transfer_matrix(torch.zeros(12, 2, 4), w, n_states=64, n_slots=4,
                        transfer_tile=8)
    with pytest.raises(ValueError, match="unknown semiring"):
        transfer_matrix(torch.zeros(8, 2, 4), w, n_states=64, n_slots=4,
                        transfer_tile=8, semiring="maxplus")
    # a tile longer than the call is cut to the call, as in the reference
    assert transfer_matrix(torch.zeros(8, 2, 4), w, n_states=64, n_slots=4,
                           transfer_tile=32).shape == (1, 2, 64, 64)


def _k3_cuda_cases():
    """(label, spec, rho, transfer tile) of the cuda K3 tests: ccsds-k7 at
    rho = 2 (rotation period 3; tiles of every residue), 1 (period 6)
    and 3 (period 2), and gsm-cs1 (S = 16) at rho = 2 and 3."""
    from repro_torch.codes import get_code

    k7, gsm = get_code("ccsds-k7").spec, get_code("gsm-cs1").spec
    return [("k7 rho2 TT32", k7, 2, 32), ("k7 rho2 TT96", k7, 2, 96),
            ("k7 rho2 TT64", k7, 2, 64), ("k7 rho2 TT8", k7, 2, 8),
            ("k7 rho1 TT32", k7, 1, 32), ("k7 rho1 TT7", k7, 1, 7),
            ("k7 rho3 TT8", k7, 3, 8), ("k7 rho3 TT5", k7, 3, 5),
            ("gsm rho2 TT32", gsm, 2, 32), ("gsm rho3 TT7", gsm, 3, 7)]


@pytest.mark.cuda
def test_cuda_k3_matches_plain():
    """K3 against its plain version on the card, bit for bit on integer
    and on Gaussian LLRs, over the precision policies, a ragged last
    block, two codes, three radixes and tiles of every residue of the
    register rotation; a W that is not the shift register's raises before
    any launch (needs an H100 and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import transfer_matrix
    from repro_torch.kernels.ref import transfer_matrix_ref

    dev = torch.device("cuda")
    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w, device=dev)
    blocks, _ = _inputs(CODE_K7_CCSDS, 2, 13, 256, 13, True, None)
    blocks = torch.from_numpy(blocks).to(dev)
    for mm in (torch.float32, torch.bfloat16):
        for split in (False, True):
            kw = dict(n_states=64, n_slots=4, transfer_tile=32,
                      matmul_dtype=mm, carry_dtype=torch.bfloat16,
                      split_dot=split)
            got = transfer_matrix(blocks, w, **kw)
            want = transfer_matrix_ref(blocks, w, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    for label, spec, rho, tile in _k3_cuda_cases():
        tb = build_acs_tables(spec, rho)
        wc = torch.as_tensor(tb.fused_w, device=dev)
        for integer in (True, False):
            x, _ = _inputs(spec, rho, 13, 2 * tile, 14, integer, None)
            x = torch.from_numpy(x).to(dev)
            kw = dict(n_states=tb.n_states, n_slots=tb.n_slots, transfer_tile=tile)
            got = transfer_matrix(x, wc, **kw)
            # Gaussian sums round in the order they are taken: K3 and the
            # plain version on the CPU take W's rows in k order, the card's
            # matmul in an order it picks by the shape
            want = transfer_matrix_ref(x if integer else x.cpu(),
                                       wc if integer else wc.cpu(), **kw)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want.cpu()), (label, integer)
    bad = w.clone()
    bad[4:] = bad[4:].roll(1, dims=0)
    before = transfer_matrix.launches
    with pytest.raises(ValueError, match="other predecessors"):
        transfer_matrix(blocks, bad, n_states=64, n_slots=4, transfer_tile=32)
    assert transfer_matrix.launches == before


# -- the LOGPROB variants of K1 and K3 ------------------------------------

def _logprob_blocks(spec, F, T, seed):
    """Half-scaled Gaussian scores (the BCJR's branch log-likelihoods)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 3.0, (T, F, 2 * spec.beta)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("renorm,pack", [(True, False), (False, True)],
                         ids=["renorm-int8", "raw-packed"])
@pytest.mark.parametrize("init", [0, None], ids=["pinned", "uniform"])
def test_k1_logprob_matches_reference(init, renorm, pack):
    """K1's wrapper at LOGPROB (its plain version here) against the
    reference's interpret-mode K1 at semiring="logprob"."""
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import AcsPrecision as RefPrecision
    from repro.kernels.ops import viterbi_forward as ref_forward

    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.core.soft import _alpha_scan
    from repro_torch.core.viterbi import AcsPrecision, fused_potentials
    from repro_torch.kernels import acs_forward

    spec = CODE_K7_CCSDS
    blocks = _logprob_blocks(spec, 5, 48, 21)
    _, lam0 = _inputs(spec, 2, 5, 1, 0, True, init)
    lam_r, phi_r = ref_forward(
        jnp.asarray(blocks), jnp.asarray(lam0), ref_tables(_ref_spec(spec), 2),
        RefPrecision(renorm=renorm), pack_survivors=pack, semiring="logprob",
    )
    tb = build_acs_tables(spec, 2)
    tb_args = (torch.from_numpy(blocks), torch.from_numpy(lam0),
               torch.from_numpy(tb.fused_w))
    lam_p, phi_p = acs_forward(*tb_args, n_states=64, n_slots=4, renorm=renorm,
                               pack_survivors=pack, semiring="logprob")
    np.testing.assert_allclose(lam_p.numpy(), np.asarray(lam_r), atol=1e-4, rtol=0)
    # survivors: equal wherever the top two potentials differ by > 1e-3
    prec = AcsPrecision(renorm=renorm)
    alphas = _alpha_scan(tb_args[0], tb_args[1], tb, prec)
    prev = torch.cat([tb_args[1][None], alphas[:-1]]).reshape(-1, 64)
    w = tb_args[2]
    pot = fused_potentials(tb_args[0].reshape(-1, 4), prev, w, w[:4], w[4:], prec)
    top = pot.view(48, 5, 64, 4).topk(2, dim=-1).values
    decided = ((top[..., 0] - top[..., 1]) > 1e-3).numpy()
    phi_p, phi_r = phi_p.numpy(), np.asarray(phi_r)
    if pack:  # a word is held where all 16 of its slots are decided
        decided = decided.reshape(48, 5, 4, 16).all(axis=-1)
    np.testing.assert_array_equal(phi_p[decided], phi_r[decided])
    assert decided.mean() > 0.5


def _logprob_potential_gaps(blocks, lam0, tb, renorm):
    """(T, F, S) gap between the top two potentials of each state at each
    step, the metrics carried by the port's plain LOGPROB forward."""
    from repro_torch.core.soft import _alpha_scan
    from repro_torch.core.viterbi import AcsPrecision, fused_potentials

    T, F, B = blocks.shape
    S, R = tb.n_states, tb.n_slots
    prec = AcsPrecision(renorm=renorm)
    alphas = _alpha_scan(blocks, lam0, tb, prec)
    prev = torch.cat([lam0[None], alphas[:-1]]).reshape(-1, S)
    w = torch.from_numpy(tb.fused_w)
    pot = fused_potentials(blocks.reshape(-1, B), prev, w, w[:B], w[B:], prec)
    top = pot.view(T, F, S, R).topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


K1_MODEL_CASES = [
    (code, rho, renorm, pack) for code in ("ccsds-k7", "gsm-cs1") for rho in (1, 2, 3, 4)
    for renorm in (True, False) for pack in ((False, True) if rho <= 2 else (False,))
]  # packed where 16 slots fit a word


@pytest.mark.parametrize(
    "code,rho,renorm,pack", K1_MODEL_CASES,
    ids=[f"{c}-rho{r}-{'renorm' if n else 'raw'}-{'packed' if p else 'int8'}"
         for c, r, n, p in K1_MODEL_CASES])
def test_k1_gathered_logprob_model_matches_reference(code, rho, renorm, pack):
    """``acs_forward_gather_ref``, the model of K1's gathered LOGPROB step
    in the kernel's arithmetic order (branch metrics by fmaf in k order,
    one add of the predecessor metric, the tournament logsumexp), against
    the reference's interpret-mode K1 at semiring="logprob", by
    ``test_k1_logprob_matches_reference``'s criteria: metrics within atol
    1e-4, survivors equal wherever the top two potentials differ by more
    than 1e-3.  Renormalised runs start pinned to state 0 (the -1e9
    entries), raw ones from all-equal metrics."""
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.core.viterbi import AcsPrecision as RefPrecision
    from repro.kernels.ops import viterbi_forward as ref_forward

    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables
    from repro_torch.kernels.ref import acs_forward_gather_ref

    spec = get_code(code).spec
    tb = build_acs_tables(spec, rho)
    F, T = 5, 48 // rho
    rng = np.random.default_rng(10 * rho + len(code))
    blocks = (rng.normal(0.0, 3.0, (T, F, tb.llr_block)) * 0.5).astype(np.float32)
    _, lam0 = _inputs(spec, rho, F, 1, 0, True, 0 if renorm else None)
    lam_r, phi_r = ref_forward(
        jnp.asarray(blocks), jnp.asarray(lam0), ref_tables(_ref_spec(spec), rho),
        RefPrecision(renorm=renorm), pack_survivors=pack, semiring="logprob",
    )
    args = (torch.from_numpy(blocks), torch.from_numpy(lam0))
    lam_m, phi_m = acs_forward_gather_ref(
        *args, torch.from_numpy(tb.fused_w), n_states=tb.n_states,
        n_slots=tb.n_slots, renorm=renorm, pack_survivors=pack, semiring="logprob")
    np.testing.assert_allclose(lam_m.numpy(), np.asarray(lam_r), atol=1e-4, rtol=0)
    decided = (_logprob_potential_gaps(*args, tb, renorm) > 1e-3).numpy()
    if pack:  # a word is held where all 16 of its slots are decided
        decided = decided.reshape(T, F, tb.n_states // 16, 16).all(axis=-1)
    phi_m, phi_r = phi_m.numpy(), np.asarray(phi_r)
    assert phi_m.shape == phi_r.shape
    np.testing.assert_array_equal(phi_m[decided], phi_r[decided])
    assert decided.mean() > 0.5


@pytest.mark.parametrize("rho", [1, 2, 3, 4])
@pytest.mark.parametrize("code", ["ccsds-k7", "gsm-cs1"])
def test_k1_gathered_model_is_the_plain_version_at_tropical(code, rho):
    """At TROPICAL the gathered model (a branch metric plus the one
    predecessor metric) gives the plain version's bits, on integer LLRs
    where ties abound, at f32 and bf16 matmul and carry, packed where 16
    slots fit a word: the potentials are the dense sum's values."""
    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables
    from repro_torch.kernels.ref import acs_forward_gather_ref, acs_forward_ref

    spec = get_code(code).spec
    tb = build_acs_tables(spec, rho)
    rng = np.random.default_rng(rho)
    blocks = torch.from_numpy(rng.integers(-8, 9, (40, 5, tb.llr_block)).astype(np.float32))
    w = torch.from_numpy(tb.fused_w)
    for mm, renorm, pack in ((torch.float32, True, False),
                             (torch.bfloat16, False, rho <= 2)):
        lam0 = torch.zeros((5, tb.n_states))
        kw = dict(n_states=tb.n_states, n_slots=tb.n_slots, matmul_dtype=mm,
                  carry_dtype=mm, renorm=renorm, pack_survivors=pack)
        got = acs_forward_gather_ref(blocks, lam0, w, **kw)
        want = acs_forward_ref(blocks, lam0, w, **kw)
        for g, r in zip(got, want):
            assert g.dtype == r.dtype and torch.equal(g, r)


def _k3_logprob_pair(code, F, T, tile, seed, mm="f32", split=False):
    import jax.numpy as jnp
    from repro.core.trellis import build_acs_tables as ref_tables
    from repro.kernels.viterbi_acs import transfer_matrix_pallas

    from repro_torch.codes import get_code
    from repro_torch.core import build_acs_tables
    from repro_torch.kernels import transfer_matrix

    spec = get_code(code).spec
    blocks = _logprob_blocks(spec, F, T, seed)
    mm_t, mm_j = _dtypes(mm)
    tb = build_acs_tables(spec, 2)
    ref = transfer_matrix_pallas(
        jnp.asarray(blocks), jnp.asarray(ref_tables(_ref_spec(spec), 2).fused_w),
        n_states=64, n_slots=4, transfer_tile=tile, matmul_dtype=mm_j,
        split_dot=split, semiring="logprob", interpret=True,
    )
    got = transfer_matrix(
        torch.from_numpy(blocks), torch.from_numpy(tb.fused_w), n_states=64,
        n_slots=4, transfer_tile=tile, matmul_dtype=mm_t, split_dot=split,
        semiring="logprob",
    )
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("code,F,T,tile,mm,split", [
    ("ccsds-k7", 5, 32, 8, "f32", False),
    ("ccsds-k7", 3, 32, 16, "bf16", True),
    ("lte-tbcc", 5, 6, 1, "f32", False),
], ids=["k7-tile8", "k7-bf16-split", "tbcc-tile1"])
def test_k3_logprob_matches_reference(code, F, T, tile, mm, split):
    """K3's plain version at LOGPROB against the reference's Pallas K3 in
    interpret mode: atol 1e-4 on reachable entries, the -1e9 of
    unreachable ones equal (at one step a tile most entries are)."""
    ref, got = _k3_logprob_pair(code, F, T, tile, F + T, mm, split)
    assert got.shape == ref.shape == (T // tile, F, 64, 64)
    reach = ref > -1e8
    np.testing.assert_array_equal(got > -1e8, reach)
    np.testing.assert_allclose(got[reach], ref[reach], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[~reach], ref[~reach])
    assert np.isfinite(got).all()
    if tile == 1:
        assert (~reach).mean() > 0.9


def _cuda_logprob_bound(steps, scale, renorm, n_llr=4, n_slots=4):
    """The f32 rounding a LOGPROB run of ``steps`` steps allows at
    ``n_llr`` LLRs and ``n_slots`` slots, values held within ``scale``
    (``renorm``) or growing by ``scale`` a step: chip_smoke.py's
    ``logprob_bound``, which derives it."""
    u = 2.0 ** -24
    rounds = n_llr + 2 + int(renorm)
    sum_x = steps * scale if renorm else scale * steps * (steps + 1) / 2
    x_end = scale if renorm else steps * scale
    return (4 * (rounds * u * sum_x + steps * (2 * n_slots + 6) * u)
            + 4 * u * x_end)


def _max_reachable_diff(a, b):
    both = (a > -1e8) & (b > -1e8)
    return (a - b)[both].abs().max().item()


@pytest.mark.cuda
def test_cuda_k1_logprob_matches_plain():
    """K1-LOGPROB against its plain version on the card (needs an H100
    and nvcc): metrics within f32 rounding, survivors equal; after 8
    steps the bound rejects the tropical instantiation; then at every
    (code, rho) of ``chip_smoke.py``'s shape sweep, and a W whose metric
    half is not the one-hot raises before any launch.  Each run is also
    held to ``acs_forward_gather_ref``, the model of the kernel's own
    arithmetic order: its LLR terms round as the kernel's do, so only the
    exponentials, the log and the roundings they move may differ
    (``n_llr=0`` in the bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.codes import get_code
    from repro_torch.core import CODE_K7_CCSDS, CodeSpec, build_acs_tables
    from repro_torch.kernels import acs_forward
    from repro_torch.kernels.ref import acs_forward_gather_ref, acs_forward_ref

    dev = torch.device("cuda")
    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    blocks, lam0 = _inputs(CODE_K7_CCSDS, 2, 40, 100, 5, True, 0)
    args = (torch.from_numpy(blocks).to(dev), torch.from_numpy(lam0).to(dev),
            torch.as_tensor(tb.fused_w, device=dev))
    kw = dict(n_states=64, n_slots=4, semiring="logprob")
    before = acs_forward.logprob_launches
    lam_k, phi_k = acs_forward(*args, **kw)
    lam_r, phi_r = acs_forward_ref(*args, **kw)
    torch.cuda.synchronize()
    assert acs_forward.logprob_launches == before + 1
    # renormalised metrics stay within 3 steps' spread (k-1 = 3 radix-4
    # steps reach every state) of 0, the potentials one step beyond
    m = args[0].abs().sum(dim=-1).max().item() + math.log(4)
    scale = 3 * (2 * m) + m
    diff = (lam_k - lam_r).abs().max().item()
    assert diff <= _cuda_logprob_bound(100, scale, True)
    assert (phi_k != phi_r).float().mean().item() < 1e-3
    lam_m, phi_m = acs_forward_gather_ref(*args, **kw)
    assert (lam_k - lam_m).abs().max().item() <= _cuda_logprob_bound(100, scale, True, 0)
    assert (phi_k != phi_m).float().mean().item() < 1e-3
    short = (args[0][:8], args[1], args[2])
    bound = _cuda_logprob_bound(8, scale, True)
    want = acs_forward_ref(*short, **kw)[0]
    assert _max_reachable_diff(acs_forward(*short, **kw)[0], want) <= bound
    trop = acs_forward(*short, **dict(kw, semiring="tropical"))[0]
    assert _max_reachable_diff(trop, want) > bound

    specs = [get_code(c).spec for c in ("ccsds-k7", "gsm-cs1", "lte-tbcc")] + [
        CodeSpec(k=6, polys=(0o53, 0o75)), CodeSpec(k=8, polys=(0o371, 0o247)),
        CodeSpec(k=10, polys=(0o1167, 0o1545))]
    rng = np.random.default_rng(7)
    for spec in specs:
        for rho in (1, 2, 3, 4):
            tbc = build_acs_tables(spec, rho)
            S, R, B = tbc.n_states, tbc.n_slots, tbc.llr_block
            x = torch.from_numpy(
                (rng.normal(0.0, 3.0, (64, 37, B)) * 0.5).astype(np.float32)).to(dev)
            wc = torch.as_tensor(tbc.fused_w, device=dev)
            l0 = torch.zeros((37, S), device=dev)
            kwc = dict(n_states=S, n_slots=R, semiring="logprob")
            lam_k, phi_k = acs_forward(x, l0, wc, **kwc)
            lam_r, phi_r = acs_forward_ref(x, l0, wc, **kwc)
            torch.cuda.synchronize()
            m = x.abs().sum(dim=-1).max().item() + math.log(R)
            d = -(-(spec.k - 1) // rho)  # steps in which every state reaches every state
            bound = _cuda_logprob_bound(64, d * (2 * m) + m, True, B, R)
            assert (lam_k - lam_r).abs().max().item() <= bound, (spec, rho)
            assert (phi_k != phi_r).float().mean().item() < 1e-3, (spec, rho)
            lam_m, phi_m = acs_forward_gather_ref(x, l0, wc, **kwc)
            bound_m = _cuda_logprob_bound(64, d * (2 * m) + m, True, 0, R)
            assert (lam_k - lam_m).abs().max().item() <= bound_m, (spec, rho)
            assert (phi_k != phi_m).float().mean().item() < 1e-3, (spec, rho)

    bad = args[2].clone()
    bad[4:] = bad[4:].roll(1, dims=0)
    launches = acs_forward.launches
    with pytest.raises(ValueError, match="one-hot|predecessors"):
        acs_forward(args[0], args[1], bad, **kw)
    assert acs_forward.launches == launches


@pytest.mark.cuda
def test_cuda_k3_logprob_matches_plain():
    """K3-LOGPROB against its plain version on the card (needs an H100
    and nvcc), at tiles of 32 and 8 steps and at one step a tile, and at
    the codes, radixes and tile residues of the tropical test; at 8 steps
    the bound rejects the tropical instantiation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core import CODE_K7_CCSDS, build_acs_tables
    from repro_torch.kernels import transfer_matrix
    from repro_torch.kernels.ref import transfer_matrix_ref

    dev = torch.device("cuda")
    w = torch.as_tensor(build_acs_tables(CODE_K7_CCSDS, 2).fused_w, device=dev)
    blocks = torch.from_numpy(_logprob_blocks(CODE_K7_CCSDS, 13, 256, 13)).to(dev)

    def check(x, wc, tb, tile, separate=False):
        kw = dict(n_states=tb.n_states, n_slots=tb.n_slots,
                  transfer_tile=tile, semiring="logprob")
        got = transfer_matrix(x, wc, **kw)
        want = transfer_matrix_ref(x, wc, **kw)
        torch.cuda.synchronize()
        reach = want > -1e8
        assert torch.equal(got > -1e8, reach)
        assert torch.equal(got[~reach], want[~reach])
        m = x.abs().sum(dim=-1).max().item() + math.log(tb.n_slots)
        bound = _cuda_logprob_bound(tile, m, False, tb.llr_block, tb.n_slots)
        assert (got - want)[reach].abs().max().item() <= bound
        if separate:
            trop = transfer_matrix(x, wc, **dict(kw, semiring="tropical"))
            assert _max_reachable_diff(trop, want) > bound

    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    for tile in (32, 8, 1):
        check(blocks, w, tb, tile, separate=tile == 8)
    for _, spec, rho, tile in _k3_cuda_cases():
        tbc = build_acs_tables(spec, rho)
        rng = np.random.default_rng(tile + rho)
        x = (rng.normal(0.0, 3.0, (2 * tile, 13, tbc.llr_block)) * 0.5)
        check(torch.from_numpy(x.astype(np.float32)).to(dev),
              torch.as_tensor(tbc.fused_w, device=dev), tbc, tile)


def test_logprob_variants_build_without_fast_math():
    """The logsumexp of K1-LOGPROB and K3-LOGPROB uses the accurate expf
    and log_of_sum (the accurate logf's own steps): no fast-math flag in
    the build, no __expf/__logf intrinsics in the shared ACS step, and
    the semiring codes the wrappers pass are the ones the kernels switch
    on."""
    import re

    from repro_torch.kernels import viterbi_acs

    flags = " ".join(viterbi_acs._NVCC_FLAGS)
    assert "fast" not in flags and "ftz=true" not in flags
    step = (viterbi_acs._CSRC / "acs_step.cuh").read_text()
    code = re.sub(r"//[^\n]*", "", step)  # the notes name the intrinsics
    assert "expf(" in code and "log_of_sum(" in code
    assert "__expf" not in code and "__logf" not in code
    assert re.search(r"kTropical = 0, kLogprob = 1", code)
    assert viterbi_acs._SEMIRING_CODES == {"tropical": 0, "logprob": 1}


# -- K4: the semiring compose of the scans --------------------------------

def _compose_operands(S, n, F, seed):
    """``associative_scan``'s three dim-0-strided operand views of an
    (n, F, S, S) stack of Gaussian matrices with NEG rows, NEG columns and
    NEG-shifted entries, as the scans' transfer matrices have them."""
    from repro_torch.core.semiring import NEG

    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(0.0, 3.0, (n, F, S, S))).astype(np.float32))
    x[:, :, 0, :] = NEG
    x[:, :, :, -1] = NEG + x[:, :, :, -1]
    return x[0:-1:2], x[1::2], x[2::2]


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, loaded as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def scan_composes(n):
    """``chip_smoke.scan_composes``: the non-empty composes (K4 launches)
    of one ``associative_scan`` over n elements."""
    return _chip_smoke().scan_composes(n)


@pytest.mark.parametrize("semiring", ["tropical", "logprob"])
@pytest.mark.parametrize("mm", DT, ids=["mmf32", "mmbf16"])
@pytest.mark.parametrize("S,n,F", [(4, 9, 3), (16, 5, 1), (64, 3, 2), (64, 1, 5),
                                   (8, 2, 7), (2, 7, 0)],
                         ids=["S4", "S16-batch2", "S64", "S64-batch0",
                              "S8-batch7", "S2-empty"])
def test_k4_plain_is_the_semiring_matmul(S, n, F, mm, semiring):
    """On CPU tensors ``semiring_compose`` (and so ``Semiring.matmul``)
    runs the plain version, ``Semiring.matmul_plain``, bit for bit and
    launching nothing, and matches the reference's semiring matmul: bit
    for bit at TROPICAL, at LOGPROB reachable where it is and within
    1e-4 there, on the scans' strided views, broadcast operands and
    batches of 0, 1 and odd sizes, at both matmul dtypes."""
    import jax.numpy as jnp
    from repro.core.semiring import get_semiring as ref_semiring

    from repro_torch.core.semiring import get_semiring
    from repro_torch.kernels import semiring_compose

    mm_t, mm_j = {"f32": (torch.float32, jnp.float32),
                  "bf16": (torch.bfloat16, jnp.bfloat16)}[mm]
    sr, ref = get_semiring(semiring), ref_semiring(semiring)
    x0, x1, x2 = _compose_operands(S, n, F, 7 * S + n)
    pairs = [(x0, x1), (x1[: len(x2)], x2), (x0[:1], x2[:1]),
             (x2, torch.eye(S).expand(F, S, S))]
    before = (semiring_compose.launches, semiring_compose.logprob_launches)
    for a, b in pairs:
        got = semiring_compose(a, b, semiring=semiring, matmul_dtype=mm_t)
        assert got.dtype == torch.float32
        assert torch.equal(got, sr.matmul_plain(a, b, mm_t))
        assert torch.equal(sr.matmul(a, b, mm_t), got)
        want = np.asarray(ref.matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), mm_j))
        got = got.numpy()
        assert got.shape == want.shape
        if semiring == "tropical":
            np.testing.assert_array_equal(got, want)
        else:
            reach = want > -1e8
            np.testing.assert_array_equal(got > -1e8, reach)
            np.testing.assert_allclose(got[reach], want[reach], atol=1e-4, rtol=0)
    assert (semiring_compose.launches, semiring_compose.logprob_launches) == before


@pytest.mark.parametrize("a_shape,b_shape,match", [
    ((2, 65, 65), (2, 65, 65), "do not fit"),
    ((2, 128, 128), (128, 128), "do not fit"),
    ((2, 4, 5), (2, 5, 5), "square"),
    ((2, 4, 4), (2, 8, 8), "square"),
    ((4, 4), (4, 5), "square"),
    ((4,), (4, 4), r"\(\.\.\., S, S\)"),
    ((0, 0), (0, 0), "square"),
], ids=["S65", "S128", "non-square-a", "mismatched", "non-square-b", "vector", "S0"])
def test_k4_refuses_what_it_cannot_hold(a_shape, b_shape, match):
    """More than 64 states, non-square or mismatched operands raise
    ValueError before anything runs, at both semirings (on the card too:
    ``test_cuda_k4_matches_plain``); an unknown semiring raises."""
    from repro_torch.kernels import semiring_compose

    for semiring in ("tropical", "logprob"):
        with pytest.raises(ValueError, match=match):
            semiring_compose(torch.zeros(a_shape), torch.zeros(b_shape),
                             semiring=semiring)
    with pytest.raises(ValueError, match="unknown semiring"):
        semiring_compose(torch.zeros(4, 4), torch.zeros(4, 4), semiring="maxplus")


def test_k4_refuses_other_devices():
    from repro_torch.kernels import semiring_compose

    with pytest.raises(ValueError, match="unsupported device"):
        semiring_compose(torch.zeros(2, 4, 4, device="meta"),
                         torch.zeros(2, 4, 4, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        semiring_compose(torch.zeros(2, 4, 4, device="meta"), torch.zeros(2, 4, 4))


def test_k4_reads_the_scans_views_where_they_lie():
    """The operand levels K4 is given: ``associative_scan``'s strided
    views and a broadcast identity are read in place (one or two levels
    of strides, no copy); a transposed or misaligned operand, or a batch
    of three levels, is copied to a contiguous one first."""
    from repro_torch.kernels.viterbi_acs import _k4_levels, _k4_operand

    x = torch.zeros(9, 3, 64, 64)
    S2 = 64 * 64
    assert _k4_levels(x) == (27, S2, 0)
    assert _k4_levels(x[0:-1:2]) == (3, S2, 6 * S2)
    assert _k4_levels(x[1::2]) == (3, S2, 6 * S2)
    assert _k4_levels(x[2::2]) == (3, S2, 6 * S2)
    assert _k4_levels(torch.eye(64).expand(3, 64, 64)) == (3, 0, 0)
    assert _k4_levels(x[0, 0]) == (1, 0, 0)
    for view in (x[1::2], torch.eye(64).expand(4, 3, 64, 64)):
        got, *levels = _k4_operand(view, view.shape[:-2])
        assert got.data_ptr() == view.data_ptr() and levels == list(_k4_levels(view))
    odd = torch.zeros(2 * S2 + 1)[1:].view(2, 64, 64)  # 4 bytes past a 16-byte line
    for view in (x.transpose(-1, -2), odd, x[::2, ::2, None].expand(5, 2, 2, 64, 64)):
        assert _k4_levels(view) is None
        got, *levels = _k4_operand(view, view.shape[:-2])
        assert got.is_contiguous() and torch.equal(got, view)
        assert levels == [got.numel() // S2, S2, 0]
    assert _k4_levels(torch.zeros(5, 3, 3)[1:]) == (4, 9, 0)  # no vector loads at S = 3


def _scan_paths():
    """Each path of the port that scans, as run(use_kernel) -> its output
    on the CPU, with the semiring its scans compose in."""
    from repro_torch.codes import get_code
    from repro_torch.codes.tailbiting import wava_decode
    from repro_torch.core import build_acs_tables
    from repro_torch.core.soft import bcjr_circular_llrs, bcjr_llrs
    from repro_torch.core.timeparallel import decode_time_parallel
    from repro_torch.distributed.decoder import (
        frame_mesh, sharded_decode_time_parallel)

    spec = get_code("ccsds-k7").spec
    tables = build_acs_tables(spec, 2)
    llrs = torch.from_numpy(
        np.random.default_rng(5).normal(1.0, 2.0, (3, 256, 2)).astype(np.float32))
    return {
        "time_parallel": ("tropical", lambda uk: decode_time_parallel(
            llrs, spec, transfer_tile=8, use_kernel=uk, device="cpu")),
        "sharded": ("tropical", lambda uk: sharded_decode_time_parallel(
            llrs, spec, mesh=frame_mesh(2, axis="tiles", device="cpu"),
            transfer_tile=8, use_kernel=uk)),
        "wava": ("tropical", lambda uk: wava_decode(
            llrs, tables, use_kernel=uk, time_parallel=True, transfer_tile=8,
            device="cpu")[0]),
        "bcjr": ("logprob", lambda uk: bcjr_llrs(
            llrs, spec, transfer_tile=8, use_kernel=uk, device="cpu")),
        "bcjr_circular": ("logprob", lambda uk: bcjr_circular_llrs(
            llrs[:, :32], tables, use_kernel=uk, device="cpu")),
    }


@pytest.mark.parametrize(
    "path", ["time_parallel", "sharded", "wava", "bcjr", "bcjr_circular"])
def test_scans_compose_in_k4_unless_use_kernel_false(path, monkeypatch):
    """``use_kernel`` selects the scans' compose as it selects K1 and K3:
    True composes through ``semiring_compose`` (K4 on the card), False
    runs ``Semiring.matmul_plain`` and never reaches the wrapper, so it
    takes any device and any S; on the CPU both give the same output."""
    from repro_torch.kernels import viterbi_acs

    real = viterbi_acs.semiring_compose
    calls = []

    def spy(a, b, *, semiring="tropical", matmul_dtype=torch.float32):
        calls.append(semiring)
        return real(a, b, semiring=semiring, matmul_dtype=matmul_dtype)

    monkeypatch.setattr(viterbi_acs, "semiring_compose", spy)
    semiring, run = _scan_paths()[path]
    on = run(True)
    assert calls and set(calls) == {semiring}
    calls.clear()
    off = run(False)
    assert not calls
    assert torch.equal(on, off)


def test_plain_scans_take_more_than_64_states(monkeypatch):
    """At 128 states (k = 8), beyond K3 and K4, ``use_kernel=False`` runs
    the time-parallel decode and the BCJR in plain PyTorch, with no call
    of K4's wrapper, and decodes noiseless frames; ``use_kernel=True``
    refuses before anything runs."""
    from repro_torch.core import CodeSpec, conv_encode
    from repro_torch.core.soft import bcjr_llrs
    from repro_torch.core.timeparallel import decode_time_parallel
    from repro_torch.kernels import viterbi_acs

    def refuse(*args, **kwargs):
        raise AssertionError("use_kernel=False reached semiring_compose")

    spec = CodeSpec(8, (0o247, 0o371))
    msg = np.random.default_rng(8).integers(0, 2, (2, 64))
    msg[:, -7:] = 0
    coded = np.stack([conv_encode(m, spec) for m in msg])  # (2, 64, 2)
    llrs = torch.from_numpy((4.0 * (1 - 2 * coded)).astype(np.float32))
    with pytest.raises(ValueError, match="128 states do not fit"):
        decode_time_parallel(llrs, spec, transfer_tile=8, device="cpu")
    monkeypatch.setattr(viterbi_acs, "semiring_compose", refuse)
    bits = decode_time_parallel(llrs, spec, transfer_tile=8, use_kernel=False,
                                device="cpu")
    assert np.array_equal(bits.numpy(), msg)
    soft = bcjr_llrs(llrs, spec, transfer_tile=8, use_kernel=False, device="cpu")
    assert np.array_equal((soft < 0).numpy().astype(msg.dtype), msg)


@pytest.mark.parametrize("n,want", [(0, 0), (1, 0), (2, 1), (3, 2), (4, 3), (5, 3),
                                    (128, 13), (512, 17)])
def test_scan_composes_counts_the_pairing_tree(n, want):
    """The launch counts the card tests and ``chip_smoke.py`` hold K4 to:
    the number of non-empty composes of an ``associative_scan`` over n,
    as a compose that counts its calls sees them."""
    from repro_torch.core.timeparallel import associative_scan

    assert scan_composes(n) == want
    calls = []

    def compose(a, b):
        calls.append(a.shape[0])
        return a + b

    associative_scan(compose, torch.zeros(n, 1))
    assert sum(1 for c in calls if c) == want


def test_k4_source_uses_accurate_expf_and_logf():
    """K4-LOGPROB takes the accurate expf and logf (no intrinsics, no
    fast-math flag in the build) and the semiring codes the wrappers
    pass; the source says it replaces no Pallas kernel."""
    import re

    from repro_torch.kernels import viterbi_acs

    assert "semiring_compose" in viterbi_acs.KERNELS
    src = (viterbi_acs._CSRC / "semiring_compose.cu").read_text()
    assert "Replaces no Pallas kernel" in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "expf(" in code and "logf(" in code
    for fast in ("__expf", "__logf", "exp2f", "__fdividef", "ex2.approx"):
        assert fast not in code
    assert re.search(r"kTropical = 0, kLogprob = 1", code)
    assert "fast" not in " ".join(viterbi_acs._NVCC_FLAGS)


def _log_stochastic(n, F, S, gen, dev):
    """(n, F, S, S) log row-stochastic matrices with NEG where a transition
    is masked (column 0 never is): their LOGPROB products stay
    log-stochastic, so a scan's values stay within a few tens of 0."""
    from repro_torch.core.semiring import NEG

    logits = torch.randn(n, F, S, S, generator=gen) * 2
    logits[..., 1:] = logits[..., 1:].masked_fill(
        torch.rand(n, F, S, S - 1, generator=gen) < 0.5, float("-inf"))
    x = torch.log_softmax(logits, dim=-1)
    return x.masked_fill(x == float("-inf"), NEG).to(dev)


@pytest.mark.cuda
def test_cuda_k4_matches_plain():
    """K4 against its plain version on the card (needs an H100 and nvcc):
    tropical products equal under ``torch.equal``, LOGPROB within 1e-4,
    at S = 4, 16 and 64, on the scans' strided views, a broadcast
    identity, batches of 0, 1 and odd sizes and the cells' first-level
    batches (512 tiles x 16 frames, 128 tiles x 256 frames), one launch a
    non-empty call; more than 64 states, S not a power of two and
    non-square or mismatched operands raise before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core.semiring import get_semiring
    from repro_torch.kernels import semiring_compose

    dev = torch.device("cuda")
    k4 = semiring_compose
    shapes = [(4, 9, 3), (4, 1, 1), (16, 7, 5), (16, 2, 1), (64, 3, 2), (64, 1, 5),
              (64, 513, 16), (64, 129, 256)]
    for S, n, F in shapes:
        x0, x1, x2 = (v.to(dev) for v in _compose_operands(S, n, F, S + n))
        pairs = [(x0, x1), (x1[: len(x2)], x2),
                 (x2, torch.eye(S, device=dev).expand(F, S, S))]
        for semiring in ("tropical", "logprob"):
            sr = get_semiring(semiring)
            for mm in (torch.float32, torch.bfloat16) if n < 100 else (torch.float32,):
                for a, b in pairs:
                    before = k4.launches, k4.logprob_launches
                    got = k4(a, b, semiring=semiring, matmul_dtype=mm)
                    want = sr.matmul_plain(a, b, mm)
                    torch.cuda.synchronize()
                    launched = int(got.numel() > 0)
                    assert (k4.launches, k4.logprob_launches) == (
                        before[0] + launched,
                        before[1] + launched * (semiring == "logprob"))
                    assert got.shape == want.shape
                    label = (S, n, F, semiring, mm)
                    if semiring == "tropical":
                        assert torch.equal(got, want), label
                    elif got.numel():
                        assert (got - want).abs().max().item() <= 1e-4, label
    before = k4.launches
    for a_shape, b_shape in (((2, 128, 128), (2, 128, 128)), ((2, 12, 12), (2, 12, 12)),
                             ((2, 4, 5), (2, 5, 5)), ((2, 4, 4), (2, 8, 8))):
        with pytest.raises(ValueError):
            k4(torch.zeros(a_shape, device=dev), torch.zeros(b_shape, device=dev))
    assert k4.launches == before


@pytest.mark.cuda
def test_cuda_k4_scans_match_the_plain_tree():
    """``associative_scan`` forward and reverse (the program's operand
    order, ``timeparallel._compose``) through K4 against the same pairing
    tree of the plain version on the card: bit for bit at TROPICAL,
    within 1e-4 at LOGPROB, in the launches the tree predicts; then the
    time-parallel decode and the BCJR at small shapes launch two scans'
    worth of K4 and nothing of its plain version's chunk loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core import timeparallel as tp
    from repro_torch.core.decoder import ViterbiDecoder
    from repro_torch.core.kernel_geometry import pick_transfer_tile
    from repro_torch.core.semiring import LOGPROB, TROPICAL
    from repro_torch.kernels import semiring_compose as k4

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(41)
    for S, n, F in ((16, 33, 3), (64, 1, 2), (64, 2, 2), (64, 7, 5), (64, 128, 4)):
        for sr in (TROPICAL, LOGPROB):
            x = (torch.randn(n, F, S, S, generator=gen).mul(3).to(dev) if sr is TROPICAL
                 else _log_stochastic(n, F, S, gen, dev))
            for reverse in (False, True):
                before = k4.launches
                got = tp.associative_scan(tp._compose(torch.float32, sr, reverse), x,
                                          reverse=reverse)
                want = tp.associative_scan(
                    (lambda a, b: sr.matmul_plain(b, a)) if reverse else sr.matmul_plain,
                    x, reverse=reverse)
                torch.cuda.synchronize()
                assert k4.launches - before == scan_composes(n)
                label = (S, n, F, sr.name, reverse)
                if sr is TROPICAL:
                    assert torch.equal(got, want), label
                else:
                    assert (got - want).abs().max().item() <= 1e-4, label
    dec = ViterbiDecoder.from_standard("ccsds-k7", device=dev)
    llrs = torch.randn(4, 2**14, 2, generator=gen).mul(2).to(dev)
    T = llrs.shape[1] // 2
    for call, tt, semiring in (
            (lambda: dec.decode_batch(llrs, time_parallel=True),
             dec._time_parallel_tile(4, T, True), "tropical"),
            (lambda: dec.decode_soft(llrs, output="llr"), pick_transfer_tile(T), "logprob")):
        k4.launches = k4.logprob_launches = 0
        call()
        torch.cuda.synchronize()
        want = 2 * scan_composes(T // tt)
        assert k4.launches == want and want > 0
        assert k4.logprob_launches == (want if semiring == "logprob" else 0)


# -- K6: the BCJR's within-tile sweeps -------------------------------------

def test_k6_source_uses_accurate_expf_and_logf():
    """K6 takes the accurate expf and logf and the shared step's
    tournament logsumexp (no intrinsics, no fast-math flag in the build),
    and its source says it replaces no Pallas kernel."""
    import re

    from repro_torch.kernels import viterbi_acs

    assert "bcjr_sweep" in viterbi_acs.KERNELS
    src = (viterbi_acs._CSRC / "bcjr_sweep.cu").read_text()
    assert "Replaces no Pallas kernel" in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "expf(" in code and "logf(" in code and "reduce_slots<R, kLogprob>" in code
    for fast in ("__expf", "__logf", "exp2f", "__fdividef", "ex2.approx"):
        assert fast not in code
    assert "fast" not in " ".join(viterbi_acs._NVCC_FLAGS)


def _k6_card_inputs(code, rho, F, n_tiles, tt, seed, dev, precision=None):
    """(tables, reverse tables, half-scaled Gaussian blocks (T', F, B) in
    ``bcjr_llrs``'s strided layout, tile-entry alphas, tile-end betas,
    the blocks' potential scale m) on the card, the boundaries from K3 and
    K4 at LOGPROB."""
    from repro_torch.codes import get_code
    from repro_torch.core import CodeSpec, build_acs_tables
    from repro_torch.core import soft
    from repro_torch.core.trellis import build_reverse_tables
    from repro_torch.core.viterbi import AcsPrecision, blocks_from_llrs, init_metric

    spec = get_code(code).spec if isinstance(code, str) else CodeSpec(*code)
    tb, rev = build_acs_tables(spec, rho), build_reverse_tables(spec, rho)
    rng = np.random.default_rng(seed)
    llrs = torch.from_numpy(
        rng.normal(0.0, 3.0, (F, n_tiles * tt * rho, spec.beta)).astype(np.float32)).to(dev)
    blocks = blocks_from_llrs(llrs, rho) * 0.5
    S = spec.n_states
    lam0 = init_metric(F, S, 0, device=dev)
    beta_end = init_metric(F, S, None, device=dev)
    entry, bte = soft._tile_boundaries(blocks, lam0, beta_end, tb,
                                       precision or AcsPrecision(), tt, True)
    m = blocks.abs().sum(dim=-1).max().item() + math.log(tb.n_slots)
    return tb, rev, llrs, blocks, entry, bte, m


def _k6_llr_bound(steps, scale, renorm, n_llr, n_slots, n_states):
    """``chip_smoke.k6_llr_bound``: how far K6-B's LLRs may lie from its
    plain version's on the same alphas in f32, which ``chip_smoke.py``
    derives and holds the kernel to."""
    return _chip_smoke().k6_llr_bound(steps, scale, n_llr, n_slots, n_states, renorm)


def _bf16_step(x):
    """The spacing of bfloat16 values (8 significant bits) at magnitudes
    below 2^e, for the least such 2^e above ``x``: 2^(e - 8)."""
    return 2.0 ** (math.frexp(x)[1] - 8)


def _k6_hold(got, want, bound, label):
    """Reachable entries (> -1e8) the same on both sides and within
    ``bound``, the -1e9 entries equal."""
    reach = want > -1e8
    assert torch.equal(got > -1e8, reach), label
    assert torch.equal(got[~reach], want[~reach]), label
    assert (got - want)[reach].abs().max().item() <= bound, label


@pytest.mark.cuda
def test_cuda_k6_matches_plain_at_the_soft_cell():
    """K6-F and K6-B against their plain versions on the card (needs an
    H100 and nvcc) at the soft cell's shape, 128 tiles x 256 frames of
    ccsds-k7 at tt 256: the alphas within ``_cuda_logprob_bound`` of
    ``bcjr_forward_ref`` (which models the kernel's branch metrics, so
    only the exponentials and the log and what they move differ), the
    LLRs on the same alphas within ``_k6_llr_bound`` of
    ``bcjr_backward_ref``, one launch each; then ``decode_soft`` (two K6
    launches) within 1e-4 of the plain scans and combine on the same
    boundaries (the soft tests' tolerance, ``K4_LOGPROB_ATOL``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core import soft
    from repro_torch.core.decoder import ViterbiDecoder
    from repro_torch.core.viterbi import AcsPrecision, init_metric
    from repro_torch.kernels import ops, viterbi_acs
    from repro_torch.kernels.ref import bcjr_backward_ref, bcjr_forward_ref

    dev = torch.device("cuda")
    F, N, tt = 256, 128, 256
    tb, rev, llrs, blocks, entry, bte, m = _k6_card_inputs("ccsds-k7", 2, F, N, tt, 36, dev)
    S, R, B = tb.n_states, tb.n_slots, tb.llr_block
    fwd, bwd = ops.device_sweep_tables(tb, rev, dev)
    k6 = viterbi_acs.bcjr_sweep
    before, back = k6.launches, k6.backward_launches
    alphas = ops.bcjr_sweep(blocks, entry, tb, rev, transfer_tile=tt)
    want_a = bcjr_forward_ref(blocks, entry, fwd, transfer_tile=tt)
    torch.cuda.synchronize()
    assert k6.launches == before + 1 and k6.backward_launches == back
    assert alphas.shape == (tt, N * F, S)
    d = -(-(tb.spec.k - 1) // 2)  # steps in which every state reaches every state
    scale = d * (2 * m) + m
    _k6_hold(alphas, want_a, _cuda_logprob_bound(tt, scale, True, 0, R), "K6-F")
    del want_a
    got = ops.bcjr_sweep(blocks, bte, tb, rev, transfer_tile=tt, alphas=alphas)
    want = bcjr_backward_ref(blocks, bte, alphas, bwd, transfer_tile=tt)
    torch.cuda.synchronize()
    assert k6.launches == before + 2 and k6.backward_launches == back + 1
    assert got.shape == (F, N * tt * 2)
    assert torch.isfinite(got).all()
    bound = _k6_llr_bound(tt - 1, scale, True, 0, R, S)
    assert (got - want).abs().max().item() <= bound
    del alphas, want, got

    dec = ViterbiDecoder.from_standard("ccsds-k7", device=dev)
    k6.launches = k6.backward_launches = 0
    out = dec.decode_soft(llrs)
    torch.cuda.synchronize()
    assert (k6.launches, k6.backward_launches) == (2, 1)
    lam0 = init_metric(F, S, 0, device=dev)
    joint = soft._bcjr_joints(blocks, lam0, init_metric(F, S, None, device=dev), tb, rev,
                              AcsPrecision(), tt, True)
    plain = soft._llrs_from_joints(joint, tb)
    assert (out - plain).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_k6_codes_radixes_and_knobs():
    """K6 against its plain version on the card at each code and radix
    (S = 16, 32, 64; rho 1..4; beta 3), rows that leave a block short, and
    under the precision knobs: in f32 (and with split_dot at a bfloat16
    matmul, where the routed metric stays f32) within the f32 bounds.
    Where a bfloat16 carry or routed metric rounds, both sides round to
    the same bfloat16 value unless their f32 values straddle a rounding
    midpoint; then one metric differs by one bfloat16 step d at the
    metrics' range X (``_bf16_step``).  Later steps move the two sides'
    metric differences only within their spread (a logsumexp takes a
    convex combination of them, a renorm shifts them all alike), so one
    such flip in a row's alphas and one in its betas move the joint's
    spread, and so an LLR, by at most 2 d: every LLR is held to the f32
    bound plus 2 d, and the median distance and 95% of the LLRs to the
    f32 bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    from repro_torch.core.viterbi import AcsPrecision
    from repro_torch.kernels import ops, viterbi_acs
    from repro_torch.kernels.ref import bcjr_sweep_ref

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    cases = [("ccsds-k7", rho, AcsPrecision()) for rho in (1, 2, 3, 4)] + [
        ("gsm-cs1", 2, AcsPrecision()), ((6, (0o53, 0o75)), 2, AcsPrecision()),
        ("lte-tbcc", 2, AcsPrecision()), ("ccsds-k7", 2, AcsPrecision(renorm=False)),
        ("ccsds-k7", 2, AcsPrecision(matmul_dtype=bf16, split_dot=True)),
        ("ccsds-k7", 2, AcsPrecision(matmul_dtype=bf16, carry_dtype=bf16)),
        ("ccsds-k7", 2, AcsPrecision(carry_dtype=bf16, channel_dtype=bf16)),
    ]
    for i, (code, rho, prec) in enumerate(cases):
        F, N, tt = 5, 3, 24
        tb, rev, _, blocks, entry, bte, m = _k6_card_inputs(code, rho, F, N, tt, 50 + i, dev,
                                                            prec)
        S, R = tb.n_states, tb.n_slots
        fwd, bwd = ops.device_sweep_tables(tb, rev, dev)
        before = viterbi_acs.bcjr_sweep.launches
        alphas = ops.bcjr_sweep(blocks, entry, tb, rev, prec, transfer_tile=tt)
        got = ops.bcjr_sweep(blocks, bte, tb, rev, prec, transfer_tile=tt, alphas=alphas)
        kw = dict(transfer_tile=tt, carry_dtype=prec.carry_dtype,
                  matmul_dtype=prec.matmul_dtype, renorm=prec.renorm,
                  split_dot=prec.split_dot)
        x = blocks.to(prec.channel_dtype).to(torch.float32)
        want = bcjr_sweep_ref(x, entry, bte, fwd, bwd, **kw)
        torch.cuda.synchronize()
        assert viterbi_acs.bcjr_sweep.launches == before + 2
        d = -(-(tb.spec.k - 1) // rho)
        scale = d * (2 * m) + m
        bound = _k6_llr_bound(2 * tt, scale, prec.renorm, 0, R, S)
        diff = (got - want).abs()
        label = (code, rho, prec.label())
        assert torch.isfinite(got).all(), label
        if prec.carry_dtype == bf16 or (prec.matmul_dtype == bf16 and not prec.split_dot):
            assert diff.median().item() <= bound, label
            assert (diff <= bound).float().mean().item() >= 0.95, label
            x = scale if prec.renorm else 2 * tt * scale
            assert diff.max().item() <= bound + 2 * _bf16_step(x), label
        else:
            assert diff.max().item() <= bound, label
