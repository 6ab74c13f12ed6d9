"""The port's support modules against the reference: kernel geometry
(survivor packing, time-parallel eligibility), input validation and the
renorm guard, the metrics registry, the code registry and the semiring."""
import numpy as np
import pytest
import torch


def test_time_parallel_plan_equals_reference():
    from repro.core import kernel_geometry as ref

    from repro_torch.core import kernel_geometry as ours

    for t_steps in (0, 3, 64, 100, 256, 4096, 32768, 65537):
        assert ours.pick_transfer_tile(t_steps) == ref.pick_transfer_tile(t_steps)
        assert ours.default_transfer_tile(t_steps) == ref.default_transfer_tile(t_steps)
        for target in (None, 8, 48):
            assert ours.pick_transfer_tile(t_steps, target) == ref.pick_transfer_tile(t_steps, target)
        for n_frames in (0, 1, 16, 512):
            for tp in (None, False, True):
                for rows in (0, 1024):
                    args = (n_frames, t_steps, 64, tp, None, rows)
                    assert ours.time_parallel_plan(*args) == ref.time_parallel_plan(*args)


def test_device_underfill_is_zero_on_the_cpu_and_auto_stays_off():
    """The CPU has no idle rows to trade into, so auto-selection never
    takes the time-parallel path there (the reference's
    ``test_decoder_auto_select_off_on_cpu``); the card's budget is the
    one measured on an H100, and decode_64k's 512 frames stay on the
    batch path under it."""
    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder
    from repro_torch.core.backend import CUDA_ROW_BUDGET, device_underfill_rows
    from repro_torch.core.kernel_geometry import time_parallel_plan

    assert device_underfill_rows(torch.device("cpu")) == 0
    assert device_underfill_rows("cpu") == 0
    assert device_underfill_rows("cuda") == device_underfill_rows() == CUDA_ROW_BUDGET
    assert 16 * 64 <= CUDA_ROW_BUDGET < 512 * 64
    d = ViterbiDecoder(CODE_K7_CCSDS, device="cpu")
    assert d._time_parallel_tile(1, 4096, None) is None
    assert d._time_parallel_tile(1, 4096, True) is not None
    assert time_parallel_plan(1, 4096, 64, None, None, 1024) == 64


def test_ring_layout_and_packing_equal_reference():
    import jax.numpy as jnp
    from repro.core import kernel_geometry as ref
    from repro.kernels.viterbi_acs import _pack_phi

    from repro_torch.core import kernel_geometry as ours

    for S in (4, 16, 64):
        for pack in (False, True):
            assert ours.ring_words(S, pack) == ref.ring_words(S, pack)
            assert ours.ring_auto_packed(S, pack) == ref.ring_auto_packed(S, pack)
            assert str(ours.ring_dtype(pack)).endswith(jnp.dtype(ref.ring_dtype(pack)).name)
    rng = np.random.default_rng(0)
    for R in (2, 4):
        phi = rng.integers(0, R, (3, 5, 64))
        np.testing.assert_array_equal(
            ours.pack_slots(torch.from_numpy(phi), R).numpy(),
            np.asarray(_pack_phi(jnp.asarray(phi), 64, ours.SLOT_BITS[R])),
        )
    with pytest.raises(ValueError, match="rho <= 2"):
        ours.check_packable(64, 8)
    # K1-LOGPROB's block, the gathered step's at ccsds-k7: a warp a frame,
    # two states a lane, four frames a block; from S = 128 one frame a block
    assert ours.gather_states_per_thread(64) == 2
    assert ours.gather_block_shape(64) == (4, 128)
    assert ours.gather_block_shape(1024) == (1, 512)


@pytest.mark.parametrize("sanitize", [False, True])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_validate_llrs_equals_reference(kind, sanitize):
    from repro.core.validate import InvalidInputError as RefInvalid
    from repro.core.validate import validate_llrs as ref_validate
    from repro.obs.metrics import MetricsRegistry as RefRegistry

    from repro_torch.core.validate import InvalidInputError, validate_llrs
    from repro_torch.obs import MetricsRegistry, set_default_registry

    x = np.array([[1.0, np.nan, -np.inf], [2e4, -3.0, np.inf]], np.float32)
    arg = x if kind == "numpy" else torch.from_numpy(x)
    reg, ref_reg = MetricsRegistry(), RefRegistry()
    if not sanitize:
        with pytest.raises(InvalidInputError) as ours_err:
            validate_llrs(arg, where="w")
        with pytest.raises(RefInvalid) as ref_err:
            ref_validate(x, where="w", registry=ref_reg)
        assert str(ours_err.value) == str(ref_err.value)
        clean = np.ones((2, 3), np.float32)
        out, n = validate_llrs(clean if kind == "numpy" else torch.from_numpy(clean))
        assert n == 0 and np.array_equal(np.asarray(out), clean)
        return
    prev = set_default_registry(reg)
    try:
        out, n = validate_llrs(arg, sanitize=True, where="w")
    finally:
        set_default_registry(prev)
    ref_out, ref_n = ref_validate(x, sanitize=True, where="w", registry=ref_reg)
    assert n == ref_n == 4
    assert isinstance(out, np.ndarray if kind == "numpy" else torch.Tensor)
    np.testing.assert_array_equal(np.asarray(out), ref_out)
    assert reg.snapshot() == ref_reg.snapshot()


def test_renorm_guard_and_headroom_equal_reference():
    import jax.numpy as jnp
    from repro.core.validate import MetricOverflowError as RefOverflow
    from repro.core.validate import RenormGuard as RefGuard
    from repro.core.validate import batch_headroom_check as ref_check
    from repro.core.viterbi import AcsPrecision as RefPrecision

    from repro_torch.core.validate import (
        MetricOverflowError, RenormGuard, batch_headroom_check,
    )
    from repro_torch.core.viterbi import AcsPrecision

    prec = AcsPrecision(carry_dtype=torch.bfloat16, renorm=False)
    ref_prec = RefPrecision(carry_dtype=jnp.bfloat16, renorm=False)
    ours, ref = RenormGuard.for_precision(prec), RefGuard.for_precision(ref_prec)
    assert (ours.soft, ours.hard) == (ref.soft, ref.hard)
    rng = np.random.default_rng(2)
    for scale, t_chunk in ((10.0, 64), (300.0, 256), (600.0, 512)):
        lam = (rng.normal(size=(3, 8)) * scale).astype(np.float32)
        lam[0, 0] = -1e9  # pinned-stream sentinel stays put
        for pos in (64, 1024, 2048):
            assert ours.due(pos, t_chunk) == ref.due(pos, t_chunk)
        out, hit = ours.observe(torch.from_numpy(lam), t_chunk=t_chunk)
        ref_out, ref_hit = ref.observe(jnp.asarray(lam), t_chunk=t_chunk)
        assert hit == ref_hit
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
        assert ours.stats() == ref.stats()
    with pytest.raises(MetricOverflowError):
        ours.observe(torch.full((2, 4), 1e5))
    with pytest.raises(RefOverflow):
        ref.observe(jnp.full((2, 4), 1e5))
    for t_steps, absmax in ((100, 4.0), (10**8, 1e4), (10**6, 1e30)):
        outcomes = []
        for fn, p in ((batch_headroom_check, prec), (ref_check, ref_prec)):
            try:
                fn(p, t_steps, absmax, 2, 2)
                outcomes.append("ok")
            except (MetricOverflowError, RefOverflow):
                outcomes.append("overflow")
        assert outcomes[0] == outcomes[1]


def test_metrics_registry_equals_reference():
    from repro.obs.metrics import MetricsRegistry as RefRegistry

    from repro_torch.obs import MetricsRegistry, NullRegistry, default_registry

    assert isinstance(default_registry(), NullRegistry)
    regs = (MetricsRegistry(), RefRegistry())
    for reg in regs:
        reg.counter("c", "help").inc(2, path="batch")
        reg.gauge("g").set(3.5, cell="a")
        h = reg.histogram("h", window=8)
        for v in (1e-3, 2e-3, 0.5, 4.0):
            h.observe(v, slo="x")
    assert regs[0].snapshot() == regs[1].snapshot()
    assert regs[0].render_prometheus() == regs[1].render_prometheus()
    assert regs[0].histogram("h").quantile(0.5) == regs[1].histogram("h").quantile(0.5)


def test_code_registry_equals_reference():
    from repro.codes import registry as ref

    from repro_torch.codes import registry as ours

    assert ours.list_codes() == ref.list_codes()
    for name in ours.list_codes():
        a, b = ours.get_code(name), ref.get_code(name)
        assert (a.spec.k, a.spec.polys) == (b.spec.k, b.spec.polys)
        assert (a.termination, a.family, a.notes) == (b.termination, b.family, b.notes)
        assert (a.puncture is None) == (b.puncture is None)
        if a.puncture is not None:
            assert a.puncture.mask == b.puncture.mask
            assert a.puncture.expansion == b.puncture.expansion
        assert a.rate == b.rate and a.expansion == b.expansion
        for n in (1, 7, 100):
            assert a.coded_len(n) == b.coded_len(n)
    with pytest.raises(KeyError, match="unknown standard"):
        ours.get_code("nope")


def test_tropical_semiring():
    from repro_torch.core.semiring import NEG, TROPICAL, Semiring

    x = torch.tensor([[1.0, 3.0, 3.0], [-2.0, NEG, 0.5]])
    assert torch.equal(TROPICAL.sum(x), torch.tensor([3.0, 0.5]))
    assert torch.tensor(NEG, dtype=torch.float32).item() == -1e9
    with pytest.raises(ValueError, match="unknown semiring"):
        Semiring("minplus")
