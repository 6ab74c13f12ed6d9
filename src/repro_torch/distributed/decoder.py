"""Frame-sharded decode over a list of devices, the part of the
reference's ``distributed/decoder.py`` that the serving engine uses.

Frames are independent: the ACS recursion never mixes information across
the frame axis, so a batch decodes on any number of devices by giving
each its own contiguous frames, with no collective at all.  The
reference does that with ``shard_map`` over a JAX ``Mesh``; JAX's mesh
has no torch form, so here the mesh is :class:`FrameMesh`, a frozen list
of devices with the ids that failures name, and each shard runs the
single-device program (``core.viterbi.decode_frames``: ``forward_fused``,
K1 once a shard, then the traceback) on its own device, one shard after
another.  The bits are those of one device's ``decode_frames`` by
construction.

``frame_mesh(n, device=...)`` puts ``n`` logical shards on one device:
the CPU tests run shards that way, as the reference's tests do with
``--xla_force_host_platform_device_count``, and so does a host with one
card.

The reference's ``sharded_decode_streams`` and
``sharded_decode_time_parallel`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as tnf

from repro_torch.core.backend import resolve_device
from repro_torch.core.trellis import CodeSpec
from repro_torch.core.validate import validate_llrs
from repro_torch.core.viterbi import AcsPrecision, decode_frames

__all__ = [
    "FrameMesh",
    "frame_mesh",
    "engine_dispatch_ready",
    "replan_mesh",
    "sharded_decode_frames",
]


@dataclasses.dataclass(frozen=True)
class FrameMesh:
    """A 1-D mesh of shards: ``devices[i]`` runs shard i, whose id (the
    one ``DeviceFailure`` and ``replan_mesh`` name) is ``ids[i]``.
    Several shards may share a device."""

    devices: Tuple[torch.device, ...]
    ids: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("frames",)

    def __post_init__(self):
        if len(self.devices) != len(self.ids) or not self.devices:
            raise ValueError(
                f"a mesh needs one id per device and at least one device, "
                f"got {len(self.devices)} devices and {len(self.ids)} ids"
            )
        if len(self.axis_names) != 1:
            raise ValueError(f"a frame mesh has one axis, got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def frame_mesh(n_devices: Optional[int] = None, axis: str = "frames",
               device=None) -> FrameMesh:
    """A 1-D mesh.  Without ``device``: the first ``n_devices`` (default
    all) CUDA devices, ids their indexes; raises where there is no card.
    With ``device``: ``n_devices`` (default 1) logical shards on that one
    device, ids 0..n-1."""
    if device is not None:
        dev = resolve_device(device)
        n = 1 if n_devices is None else int(n_devices)
        if n < 1:
            raise ValueError(f"n_devices must be >= 1, got {n}")
        return FrameMesh((dev,) * n, tuple(range(n)), (axis,))
    resolve_device("cuda")  # raises where torch sees no card
    n_all = torch.cuda.device_count()
    n = n_all if n_devices is None else int(n_devices)
    if not 1 <= n <= n_all:
        raise ValueError(f"n_devices={n_devices}, but {n_all} CUDA devices")
    return FrameMesh(
        tuple(torch.device("cuda", i) for i in range(n)), tuple(range(n)),
        (axis,),
    )


def engine_dispatch_ready(
    n_frames: int, mesh: Optional[FrameMesh] = None, axis: str = "frames"
) -> bool:
    """Whether a serving-engine cell should take the sharded route: its
    frame count fills every shard of ``mesh`` without remainder.  Engine
    cells are already padded to frame rungs; an underfilled cell stays on
    one device rather than be padded again."""
    mesh = mesh or frame_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    return n_frames >= n_dev and n_frames % n_dev == 0


def replan_mesh(mesh: FrameMesh, failed_devices) -> Optional[FrameMesh]:
    """Shrink a mesh onto its survivors: drop every shard whose id is in
    ``failed_devices`` and keep the largest power-of-two prefix of the
    rest (``runtime.failure.ElasticPlanner``'s rule; engine frame rungs
    are powers of two, so ``engine_dispatch_ready`` stays exact).  None
    when no shard survives."""
    failed = set(int(d) for d in failed_devices)
    alive = [(d, i) for d, i in zip(mesh.devices, mesh.ids) if i not in failed]
    if not alive:
        return None
    n = 1 << (len(alive).bit_length() - 1)
    devices, ids = zip(*alive[:n])
    return FrameMesh(tuple(devices), tuple(ids), mesh.axis_names)


def sharded_decode_frames(
    llrs,
    spec: CodeSpec,
    rho: int = 2,
    mesh: Optional[FrameMesh] = None,
    axis: str = "frames",
    initial_state: Optional[int] = 0,
    final_state: Optional[int] = None,
    precision: Optional[AcsPrecision] = None,
    use_kernel: bool = True,
    pack_survivors: bool = False,
) -> torch.Tensor:
    """Batch decode with the frame axis split over ``mesh``.

    llrs: (F, n, beta) -> bits (F, n) int32 on the first shard's device.
    F is zero-LLR padded up to a multiple of the shard count; shard i
    decodes frames [i F'/n, (i+1) F'/n) on ``mesh.devices[i]``; the bits
    are gathered on the first shard's device and cut to F.
    """
    mesh = mesh or frame_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    # a single NaN entering a shard poisons every path metric it touches
    llrs, _ = validate_llrs(llrs, where="sharded")
    llrs = torch.as_tensor(llrs).to(torch.float32)
    F = llrs.shape[0]
    pad = (-F) % n_dev
    if pad:
        llrs = tnf.pad(llrs, (0, 0, 0, 0, 0, pad))
    per = llrs.shape[0] // n_dev
    precision = precision or AcsPrecision()
    home = mesh.devices[0]
    outs = []
    for i, dev in enumerate(mesh.devices):
        outs.append(decode_frames(
            llrs[i * per:(i + 1) * per].to(dev), spec, rho=rho,
            initial_state=initial_state, final_state=final_state,
            precision=precision, use_kernel=use_kernel,
            pack_survivors=pack_survivors, device=dev,
        ).to(home))
    return torch.cat(outs, dim=0)[:F]
