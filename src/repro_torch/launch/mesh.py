"""Meshes of logical shards (DESIGN.md §5), the port of the reference's
``launch/mesh.py``.

Axes:
  * ``pod``   -- inter-pod data parallelism (2 pods in the dry-run target)
  * ``data``  -- intra-pod data/FSDP parallelism
  * ``model`` -- tensor / expert / sequence parallelism

A :class:`Mesh` is an N-D grid of logical shards with named axes; shard
``i`` (row-major over ``shape``) runs on ``devices[i]``, and several
shards may share one device.  The reference's mesh is a grid of JAX
devices, and ``jax.make_mesh`` needs one device per shard; torch has no
such grid, and NCCL refuses two ranks on one card, so here a shard is a
unit of ownership (the pieces of a sharded tensor, ``distributed.
sharding.ShardedTensor``) that the sharded steps run one after another,
as ``distributed/decoder.py`` runs a :class:`FrameMesh`'s shards.
``FrameMesh`` stays the 1-D mesh of the Viterbi paths and of
``optim/compress.py``, with the device ids that failures name; a
``Mesh`` is the N-D grid that the LM testbed's sharding rules read
(``shape``, ``axis_names``), and neither converts into the other.

``with mesh:`` sets the ambient mesh that ``sharding.constrain`` and
``sharding.kv_cache_constraint`` read, as the reference's ``with mesh:``
sets JAX's.  The ambient mesh is per thread.

``make_test_mesh`` and ``make_production_mesh`` are functions, so
importing this module touches no device.  Without ``device`` their
shards are the card's (shard i on ``cuda:i % device_count``), and a host
with no card raises, as ``frame_mesh`` does; ``device="cpu"`` puts every
shard on the CPU (the tests), ``device="meta"`` on the meta device (the
dry run, which allocates nothing).
"""
from __future__ import annotations

import math
import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.backend import resolve_device

__all__ = ["Mesh", "current_mesh", "make_production_mesh", "make_test_mesh",
           "dp_axes", "DP_AXES", "mesh_device"]

DP_AXES = ("pod", "data")  # batch axes, in order

_AMBIENT = threading.local()


def mesh_device(device) -> torch.device:
    """``resolve_device``, plus ``"meta"`` for the dry run."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class Mesh:
    """An N-D grid of logical shards over named axes.

    ``shape`` is ``{axis: size}`` in axis order (the reference's
    ``mesh.shape``), ``size`` the shard count and ``devices`` a tuple of
    one ``torch.device`` a shard, row-major over the axes."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device]):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
        if any(s < 1 for s in shape) or len(devices) != math.prod(shape):
            raise ValueError(
                f"a mesh of shape {shape} needs {math.prod(shape)} devices, "
                f"got {len(devices)}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.devices: Tuple[torch.device, ...] = tuple(devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, shard: int) -> dict:
        """``{axis: index}`` of shard ``shard`` (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            shard, out[name] = divmod(shard, self.shape[name])
        return {a: out[a] for a in self.axis_names}

    def shard_at(self, **coords) -> int:
        """The shard at ``coords`` (axes left out at 0)."""
        i = 0
        for name in self.axis_names:
            i = i * self.shape[name] + coords.get(name, 0)
        return i

    def __enter__(self) -> "Mesh":
        stack = getattr(_AMBIENT, "stack", None)
        if stack is None:
            stack = _AMBIENT.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.stack.pop()

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices})
        return f"Mesh({self.shape}, devices={devs})"


def current_mesh() -> Optional[Mesh]:
    """The innermost ``with mesh:`` of this thread, or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def _devices(n: int, device) -> Tuple[torch.device, ...]:
    if device is not None:
        return (mesh_device(device),) * n
    resolve_device("cuda")  # raises where torch sees no card
    n_cards = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % n_cards) for i in range(n))


def make_production_mesh(multi_pod: bool = False, device=None) -> Mesh:
    """The dry-run target: (16, 16) over (data, model), or (2, 16, 16)
    over (pod, data, model) with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, _devices(math.prod(shape), device))


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> Mesh:
    """A small mesh for tests and for the card's logical shards."""
    return Mesh(shape, axes, _devices(math.prod(shape), device))


def dp_axes(mesh) -> tuple:
    """The batch (data-parallel) axes present in this mesh."""
    return tuple(a for a in DP_AXES if a in mesh.axis_names)
