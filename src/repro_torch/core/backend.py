"""Device resolution and the Hopper probe.

The reference picks between Mosaic lowering and Pallas interpret mode
from the JAX backend.  Here the choice follows the tensors: a wrapper
launches its CUDA kernel for a CUDA tensor and runs its plain PyTorch
version for a CPU tensor.  What this module decides is which device the
decoder's entry points put their tensors on, and it never falls back to
the CPU when a card was asked for.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "is_hopper", "device_underfill_rows"]


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means the card.  Raises when a CUDA device is asked for
    (or implied) and none is present; only an explicit ``"cpu"`` gives
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA "
                "device; pass device='cpu' to run the plain versions"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")


def is_hopper(device: torch.device) -> bool:
    """True for a compute-capability 9.0 card, the only target the CUDA
    kernels are compiled for (``sm_90a``)."""
    return (
        device.type == "cuda"
        and torch.cuda.get_device_capability(device) == (9, 0)
    )


# Rows (frames x states) at or under which the time-parallel decode beats
# the sequential one on an H100, re-derived on the card by
# ``chip_smoke.py``'s budget sweep (``PERF.md`` §5): decode_batch at
# 2^16 stages of ccsds-k7, time_parallel False against True, at
# F in {1, 4, 16, 64, 256}; the budget is the largest F x S at which the
# time-parallel path was faster in every sample.  The win comes mostly
# from the sequential path's plain traceback (one Python step per radix
# step), not from the depth of the ACS: re-derive the budget once the
# traceback is a kernel.
CUDA_ROW_BUDGET = 16384


def device_underfill_rows(device=None) -> int:
    """Parallel-row budget of ``device`` (``None`` is the card) for the
    time-parallel auto-selection (``kernel_geometry.time_parallel_plan``):
    shapes with ``n_frames * n_states`` at or under it take the
    time-parallel path.  0 on the CPU, as in the reference off an
    accelerator, so auto-selection never engages there; on the card, the
    budget measured on an H100 (``CUDA_ROW_BUDGET``), not the
    reference's 1024 of "8 TPU cores x 128 lanes"."""
    dev = torch.device("cuda" if device is None else device)
    return CUDA_ROW_BUDGET if dev.type == "cuda" else 0
