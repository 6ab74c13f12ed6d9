"""The LM testbed's configs: ``repro_torch.configs`` against
``repro.configs`` for the ten architectures, field for field, with
their parameter counts, the shape cells, ``cell_applicable`` and
``input_specs``."""
import dataclasses

import numpy as np
import pytest
import torch

from tests._torch_lm import ARCHS


def _pair(arch, smoke):
    from repro import configs as ref

    from repro_torch import configs

    if smoke:
        return configs.get_smoke_config(arch), ref.get_smoke_config(arch)
    return configs.get_config(arch), ref.get_config(arch)


@pytest.mark.parametrize("smoke", [False, True], ids=["CONFIG", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_config_equals_the_reference(arch, smoke):
    got, want = _pair(arch, smoke)
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    for prop in ("head_dim_", "padded_vocab", "d_inner", "ssm_heads", "attn_free",
                 "sub_quadratic"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.n_layers = 1


def test_registry_ids_and_exports():
    from repro import configs as ref

    from repro_torch import configs

    assert configs.ARCH_IDS == ref.ARCH_IDS == ARCHS
    assert configs.ALL_IDS == ref.ALL_IDS
    for name in ("ArchConfig", "ShapeCell", "SHAPE_CELLS", "cell_applicable",
                 "input_specs"):
        assert hasattr(configs, name), name
    assert configs.get_config("smollm-135m").n_layers == 30


def test_shape_cells_and_applicability():
    from repro.configs import base as ref

    from repro_torch.configs import base

    assert list(base.SHAPE_CELLS) == list(ref.SHAPE_CELLS)
    for name, cell in base.SHAPE_CELLS.items():
        assert dataclasses.astuple(cell) == dataclasses.astuple(ref.SHAPE_CELLS[name])
    for arch in ARCHS:
        got, want = _pair(arch, False)
        for name in base.SHAPE_CELLS:
            assert base.cell_applicable(got, base.SHAPE_CELLS[name]) == \
                ref.cell_applicable(want, ref.SHAPE_CELLS[name]), (arch, name)
    assert base.pad_vocab(92553) == ref.pad_vocab(92553) == 92672


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes(arch):
    from repro.configs import base as ref

    from repro_torch.configs import base

    got_cfg, want_cfg = _pair(arch, False)
    for name, cell in base.SHAPE_CELLS.items():
        got = base.input_specs(got_cfg, cell)
        want = ref.input_specs(want_cfg, ref.SHAPE_CELLS[name])
        assert list(got) == list(want), (arch, name)
        for key, (shape, dtype) in got.items():
            assert shape == want[key].shape, (arch, name, key)
            assert dtype == base.torch_dtype(np.dtype(want[key].dtype).name)


def test_torch_dtype():
    from repro_torch.configs.base import torch_dtype

    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    assert torch_dtype("int8") is torch.int8
    with pytest.raises(ValueError, match="unknown dtype"):
        torch_dtype("float8")
