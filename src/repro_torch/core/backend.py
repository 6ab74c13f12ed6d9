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


def device_underfill_rows() -> int:
    """Parallel-row budget below which the time-parallel decode would be
    auto-selected (``kernel_geometry.time_parallel_plan``).

    The reference's 1024 is "8 TPU cores x 128 lanes" and says nothing
    about an H100's 132 SMs.  The time-parallel path (and its transfer
    matrix kernel) belongs to a later slice of the port, so until then
    the budget is 0 and auto-selection never engages it.
    """
    return 0
