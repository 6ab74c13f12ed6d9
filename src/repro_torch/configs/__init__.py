"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The ten LM architectures of the testbed (``ARCH_IDS``, one module each
over ``configs/base.py``) and the Viterbi service config
(``viterbi-k7``, ``configs/viterbi_k7.py``), as in the reference.
"""
from __future__ import annotations

import importlib

from .base import (  # noqa: F401
    ArchConfig,
    SHAPE_CELLS,
    ShapeCell,
    cell_applicable,
    input_specs,
)

__all__ = [
    "ARCH_IDS", "ALL_IDS", "ArchConfig", "SHAPE_CELLS", "ShapeCell",
    "cell_applicable", "get_config", "get_smoke_config", "input_specs",
]

_MODULES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "glm4-9b": "glm4_9b",
    "minitron-4b": "minitron_4b",
    "smollm-135m": "smollm_135m",
    "musicgen-large": "musicgen_large",
    "internvl2-2b": "internvl2_2b",
    "arctic-480b": "arctic_480b",
    "mixtral-8x7b": "mixtral_8x7b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-370m": "mamba2_370m",
    "viterbi-k7": "viterbi_k7",
}

ARCH_IDS = [a for a in _MODULES if a != "viterbi-k7"]  # the 10 LM archs
ALL_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
