"""The service config and its cells: ``repro_torch.configs`` against
``repro.configs`` field for field, and ``ViterbiDecoder.from_config`` of
each config against the reference's ``from_config`` on the same
numpy-seeded LLRs.

The reference's ``KERNEL_CONFIGS`` are TPU autotune output; the port's
are empty, so its ``config_for_cell`` is held to the reference's
``config_for_standard(cell.code)``, not to its ``config_for_cell``.
Decoded bits are held exactly: both sides decode integer LLRs on the
same path (``use_kernel`` paired, ``time_parallel=False``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_serving import CODES, _llrs

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _plain(value):
    """A config field's value in a form both packages compare by."""
    if hasattr(value, "polys"):  # CodeSpec
        return ("spec", value.k, tuple(value.polys))
    return value


def _same_config(got, want):
    gf = [f.name for f in dataclasses.fields(got)]
    assert gf == [f.name for f in dataclasses.fields(want)]
    for name in gf:
        assert _plain(getattr(got, name)) == _plain(getattr(want, name)), name
    assert got.tiled.frame_len == want.tiled.frame_len
    assert got.tiled.overlap == want.tiled.overlap
    assert got.tiled.rho == want.tiled.rho
    gp, wp = got.precision, want.precision
    for knob in ("matmul_dtype", "carry_dtype", "channel_dtype"):
        assert getattr(gp, knob) == _DTYPES[np.dtype(getattr(wp, knob)).name], knob
    assert (gp.renorm, gp.split_dot) == (wp.renorm, wp.split_dot)


def _configs(mod):
    out = {"CONFIG": mod.CONFIG, "CONFIG_OPTIMIZED": mod.CONFIG_OPTIMIZED,
           "smoke": mod.smoke_config()}
    out.update({f"std:{c}": mod.config_for_standard(c) for c in CODES})
    return out


def test_viterbi_config_defaults_and_fields():
    from repro.configs import viterbi_k7 as ref

    from repro_torch.configs import viterbi_k7 as ours

    _same_config(ours.ViterbiConfig(), ref.ViterbiConfig())
    assert ours.CONFIG == ours.ViterbiConfig()
    assert ours.CONFIG_OPTIMIZED.precision.matmul_dtype == torch.bfloat16
    assert ours.CONFIG_OPTIMIZED.pack_survivors and ours.CONFIG_OPTIMIZED.frame_len == 128
    with pytest.raises(dataclasses.FrozenInstanceError):
        ours.CONFIG.rho = 3


@pytest.mark.parametrize("which", ["CONFIG", "CONFIG_OPTIMIZED", "smoke"]
                         + [f"std:{c}" for c in CODES])
def test_configs_equal_the_reference(which):
    from repro.configs import viterbi_k7 as ref

    from repro_torch.configs import viterbi_k7 as ours

    _same_config(_configs(ours)[which], _configs(ref)[which])


def test_config_for_standard_overrides_and_unknown_code():
    from repro.configs import viterbi_k7 as ref

    from repro_torch.configs import viterbi_k7 as ours

    kw = dict(frame_len=256, time_parallel=True, transfer_tile=16)
    _same_config(ours.config_for_standard("gsm-cs1", **kw),
                 ref.config_for_standard("gsm-cs1", **kw))
    with pytest.raises(KeyError):
        ours.config_for_standard("no-such-code")


def test_cells_kernel_configs_and_input_specs():
    from repro.configs import viterbi_k7 as ref

    from repro_torch.configs import viterbi_k7 as ours

    assert list(ours.VITERBI_CELLS) == list(ref.VITERBI_CELLS)
    for name, cell in ours.VITERBI_CELLS.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref.VITERBI_CELLS[name])
        # no tuned geometry: a cell resolves to its standard's config
        assert ours.kernel_config_for(name) == ours.KernelConfig()
        assert ours.apply_kernel_config(ours.CONFIG, name) is ours.CONFIG
        _same_config(ours.config_for_cell(name),
                     ref.config_for_standard(ref.VITERBI_CELLS[name].code))
        shape, dtype = ours.input_specs(ours.config_for_cell(name), cell)["llrs"]
        want = ref.input_specs(ref.config_for_cell(name), ref.VITERBI_CELLS[name])["llrs"]
        assert shape == tuple(want.shape) and dtype == torch.float32
    assert ours.KERNEL_CONFIGS == {}
    _same_config(ours.config_for_cell("decode_1m", frame_len=32),
                 ref.config_for_standard("ccsds-k7", frame_len=32))
    # KernelConfig itself is the reference's; its overrides apply as there
    kc = ours.KernelConfig(128, 16, False, "bf16", transfer_tile=64)
    assert kc.overrides() == ref.KernelConfig(128, 16, False, "bf16", 64).overrides()
    _same_config(dataclasses.replace(ours.CONFIG, **kc.overrides()),
                 dataclasses.replace(ref.CONFIG, **kc.overrides()))


def test_registry_serves_viterbi_only():
    """The registry serves ``viterbi-k7`` and the ten LM arch ids (the
    name predates the LM slice), and raises ``KeyError`` on another id."""
    from repro import configs as ref
    from repro_torch import configs
    from repro_torch.configs import smollm_135m, viterbi_k7

    assert configs.ALL_IDS == ref.ALL_IDS and configs.ALL_IDS[-1] == "viterbi-k7"
    assert configs.ARCH_IDS == ref.ARCH_IDS and len(configs.ARCH_IDS) == 10
    assert configs.get_config("viterbi-k7") is viterbi_k7.CONFIG
    assert configs.get_smoke_config("viterbi-k7") == viterbi_k7.smoke_config()
    assert configs.get_config("smollm-135m") is smollm_135m.CONFIG
    for arch in configs.ARCH_IDS:
        assert configs.get_config(arch).name == arch
        assert configs.get_smoke_config(arch).name == f"{arch}-smoke"
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    with pytest.raises(KeyError):
        configs.get_smoke_config("no-such-arch")


def _batch_llrs(code, seed):
    """Three frames of 96 message bits of ``code`` (flushed when
    zero-terminated): integer LLRs, the serial kept stream of a
    punctured code."""
    return np.stack([_llrs(code, 96, seed + i) for i in range(3)])


@pytest.mark.parametrize("which", ["CONFIG", "CONFIG_OPTIMIZED", "smoke"]
                         + [f"std:{c}" for c in CODES])
def test_from_config_decodes_as_the_reference(which):
    """``from_config`` of each config, on both packages, decodes the same
    LLRs to the same bits through ``decode_batch`` (sequential path,
    plain scans on both sides; the port's K1 plain version as well)."""
    import jax.numpy as jnp
    from repro.configs import viterbi_k7 as ref_cfgs
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    from repro_torch.configs import viterbi_k7 as cfgs
    from repro_torch.core import ViterbiDecoder

    ours, ref = _configs(cfgs)[which], _configs(ref_cfgs)[which]
    rdec = RefDecoder.from_config(ref, use_kernel=False)
    x = _batch_llrs(ours.code, 11)
    want = np.asarray(rdec.decode_batch(jnp.asarray(x), time_parallel=False))
    for use_kernel in (False, True):
        dec = ViterbiDecoder.from_config(ours, use_kernel=use_kernel, device="cpu")
        assert (dec.termination, dec.decision_depth, dec.pack_survivors) == (
            rdec.termination, rdec.decision_depth, rdec.pack_survivors)
        assert (dec.puncture is None) == (rdec.puncture is None)
        assert dec.default_tiled_config(ours.tiled).overlap == (
            rdec.default_tiled_config(ref.tiled).overlap)
        got = dec.decode_batch(x, time_parallel=False)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_from_config_mapping_and_spec_check():
    from repro_torch.configs.viterbi_k7 import CONFIG, config_for_standard
    from repro_torch.core import DEFAULT_DECISION_DEPTH, ViterbiDecoder
    from repro_torch.core.trellis import CodeSpec

    cfg = config_for_standard("ccsds-k7", time_tile=16, block_frames=64,
                              time_parallel=True, transfer_tile=32,
                              pack_survivors=True)
    dec = ViterbiDecoder.from_config(cfg, decision_depth=512, device="cpu")
    assert (dec.time_tile, dec.block_frames, dec.time_parallel,
            dec.transfer_tile) == (16, 64, True, 32)
    assert dec.pack_survivors and dec.decision_depth == 512
    assert dec.use_kernel and dec.one_pass
    two_pass = ViterbiDecoder.from_config(CONFIG, one_pass=False, device="cpu")
    assert two_pass.use_kernel and not two_pass.one_pass
    assert ViterbiDecoder.from_config(CONFIG, device="cpu").decision_depth == (
        DEFAULT_DECISION_DEPTH)
    bad = dataclasses.replace(CONFIG, spec=CodeSpec(5, (0o23, 0o35)))
    with pytest.raises(ValueError, match="spec"):
        ViterbiDecoder.from_config(bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ViterbiDecoder.from_config(CONFIG)
