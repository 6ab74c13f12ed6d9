"""Config registry: ``get_config(arch_id)`` / ``get_smoke_config(arch_id)``.

The port registers the Viterbi service config only (``viterbi-k7``,
``configs/viterbi_k7.py``).  The reference's LM architecture configs and
their shape cells (``configs/base.py``) belong to the LM-testbed slice
of the port; their ids raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "ALL_IDS", "LM_ARCH_IDS", "get_config", "get_smoke_config"]

_MODULES = {"viterbi-k7": "viterbi_k7"}

# the reference's LM architectures, not ported yet
LM_ARCH_IDS = [
    "qwen1.5-32b", "glm4-9b", "minitron-4b", "smollm-135m", "musicgen-large",
    "internvl2-2b", "arctic-480b", "mixtral-8x7b", "hymba-1.5b", "mamba2-370m",
]

ARCH_IDS: list = []  # the LM architectures the port serves: none yet
ALL_IDS = list(_MODULES)


def _module(arch_id: str):
    if arch_id in LM_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: the LM configs belong to "
            "the LM-testbed slice of the PyTorch/CUDA port"
        )
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()
