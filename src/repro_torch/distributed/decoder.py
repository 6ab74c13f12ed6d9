"""Sharded multi-device decode, the port of the reference's
``distributed/decoder.py``.

Frames are independent: the ACS recursion never mixes information across
the frame axis, so a batch decodes on any number of devices by giving
each its own contiguous frames, with no collective at all.  The
reference does that with ``shard_map`` over a JAX ``Mesh``; JAX's mesh
has no torch form, so here the mesh is :class:`FrameMesh`, a frozen list
of devices with the ids that failures name, and each shard runs the
single-device program on its own device, one shard after another.

Three serving shapes, as in the reference:
  * ``sharded_decode_frames`` — (F, n, beta) frames, the frame axis
    split (``core.viterbi.decode_frames`` a shard: K1 once a shard, then
    the traceback); the bits are one device's by construction;
  * ``sharded_decode_streams`` — (N, n, beta) streams, the stream axis
    split, each shard's streams decoded as one window fold
    (``core.viterbi.tiled_decode_streams``: one K2, or one K1, a shard);
  * ``sharded_decode_time_parallel`` — (F, n, beta) with the TIME axis
    split: each shard forms its span's transfer matrices (K3) and scans
    them; the span products are gathered onto the first shard's device,
    where the reference has one ``all_gather``; each shard then recovers
    its tiles (K1) and traces them back.  On several cards the gathers
    are ``.to()`` copies, with no ``torch.distributed``.

Frame and stream counts that do not divide the shard count are zero-LLR
padded (``_pad_to``; a zero LLR carries no information) and the padding
is cut off.  The time-sharded path instead needs the step count to
divide: a zero-LLR tail pad would perturb the final metrics.

``frame_mesh(n, device=...)`` puts ``n`` logical shards on one device:
the CPU tests run shards that way, as the reference's tests do with
``--xla_force_host_platform_device_count``, and so does a host with one
card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as tnf

from repro_torch.core.backend import resolve_device
from repro_torch.core.kernel_geometry import pick_transfer_tile
from repro_torch.core.trellis import CodeSpec, build_acs_tables
from repro_torch.core.validate import validate_llrs
from repro_torch.core.viterbi import (
    AcsPrecision,
    TiledDecoderConfig,
    blocks_from_llrs,
    decode_frames,
    forward_fused,
    init_metric,
    tiled_decode_streams,
    traceback,
)

__all__ = [
    "FrameMesh",
    "frame_mesh",
    "engine_dispatch_ready",
    "replan_mesh",
    "sharded_decode_frames",
    "sharded_decode_streams",
    "sharded_decode_time_parallel",
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


def _pad_to(llrs: torch.Tensor, multiple: int) -> torch.Tensor:
    """``llrs`` with zero-LLR rows appended on dim 0 up to a multiple of
    ``multiple``."""
    pad = (-llrs.shape[0]) % multiple
    if not pad:
        return llrs
    return tnf.pad(llrs, (0, 0) * (llrs.dim() - 1) + (0, pad))


def _split_rows(llrs, mesh: FrameMesh, axis: str, decode) -> torch.Tensor:
    """Validate ``llrs``, zero-pad dim 0 to a multiple of the shard count,
    run ``decode(rows, device)`` on each shard's contiguous rows on its
    device, one shard after another, and gather the results on the first
    shard's device, cut to the input's row count."""
    n_dev = mesh.shape[axis]
    # a single NaN entering a shard poisons every path metric it touches
    llrs, _ = validate_llrs(llrs, where="sharded")
    llrs = torch.as_tensor(llrs).to(torch.float32)
    n = llrs.shape[0]
    llrs = _pad_to(llrs, n_dev)
    per = llrs.shape[0] // n_dev
    home = mesh.devices[0]
    outs = [decode(llrs[i * per:(i + 1) * per].to(dev), dev).to(home)
            for i, dev in enumerate(mesh.devices)]
    return torch.cat(outs, dim=0)[:n]


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
    precision = precision or AcsPrecision()
    return _split_rows(llrs, mesh or frame_mesh(axis=axis), axis, lambda x, dev: (
        decode_frames(
            x, spec, rho=rho, initial_state=initial_state,
            final_state=final_state, precision=precision,
            use_kernel=use_kernel, pack_survivors=pack_survivors, device=dev,
        )))


def sharded_decode_streams(
    llrs,
    spec: CodeSpec,
    cfg: Optional[TiledDecoderConfig] = None,
    mesh: Optional[FrameMesh] = None,
    axis: str = "frames",
    precision: Optional[AcsPrecision] = None,
    use_kernel: bool = True,
    pack_survivors: bool = False,
    one_pass: bool = False,
    time_tile: Optional[int] = None,
    block_frames: Optional[int] = None,
) -> torch.Tensor:
    """Serve-shape decode: (N, n, beta) streams, the stream axis split
    over ``mesh``; returns (N, n) int32 bits on the first shard's device.

    N is zero-LLR padded up to a multiple of the shard count; each shard
    decodes its streams as one window fold on its device
    (``tiled_decode_streams``: with ``one_pass`` one K2 launch a shard
    when the one-pass rule admits the window, else one K1 launch and a
    traceback).  Each stream's bits are ``tiled_decode_stream``'s on that
    stream alone, so the result equals the one-device fold.
    """
    cfg = cfg or TiledDecoderConfig()
    precision = precision or AcsPrecision()
    return _split_rows(llrs, mesh or frame_mesh(axis=axis), axis, lambda x, dev: (
        tiled_decode_streams(
            x, spec, cfg, precision=precision, use_kernel=use_kernel,
            pack_survivors=pack_survivors, one_pass=one_pass,
            time_tile=time_tile, block_frames=block_frames, device=dev,
        )))


def sharded_decode_time_parallel(
    llrs,
    spec: CodeSpec,
    rho: int = 2,
    mesh: Optional[FrameMesh] = None,
    axis: str = "tiles",
    initial_state: Optional[int] = None,
    final_state: Optional[int] = None,
    precision: Optional[AcsPrecision] = None,
    transfer_tile: Optional[int] = None,
    use_kernel: bool = True,
    pack_survivors: bool = False,
) -> torch.Tensor:
    """Time-sharded decode: llrs (F, n, beta) -> (F, n) int32 bits on the
    first shard's device, the transfer-matrix TILE axis spread over
    ``mesh``.

    The reference's per-device program, run shard by shard, step for
    step (``_time_parallel_fn``):
      1. each shard forms its contiguous span's transfer matrices (K3)
         and scans them (``associative_scan``); the span products
         ``prefix[-1]`` are gathered onto the first shard's device;
      2. each shard folds the products of the shards before it, in
         order d = 0 .. i-1, into its entry metric, and re-runs its
         tiles from their entry metrics (K1 over n_loc x F frames);
      3. the final state is the last shard's argmax (or the pin); each
         shard folds the products of the shards after it, d = n-1 down
         to i+1, into the best metric from its span's end to that state,
         pins its tile boundaries with its reverse scan, and traces its
         tiles back, its last tile ending where the next shard's path
         starts.
    The bits equal the reference's sharded function at the same shard
    count.  n must put a whole number of radix steps on every shard.
    """
    from repro_torch.core import timeparallel as tp

    mesh = mesh or frame_mesh(axis=axis)
    n_dev = mesh.shape[axis]
    llrs = torch.as_tensor(llrs).to(torch.float32)
    F = llrs.shape[0]
    blocks = blocks_from_llrs(llrs, rho)
    t_steps = blocks.shape[0]
    if t_steps % n_dev:
        raise ValueError(
            f"T'={t_steps} steps not divisible by {n_dev} devices — a "
            "zero-LLR tail pad would perturb the final metrics"
        )
    t_loc = t_steps // n_dev
    tile = pick_transfer_tile(t_loc, transfer_tile)
    n_loc = t_loc // tile
    precision = precision or AcsPrecision()
    mm = precision.matmul_dtype
    tables = build_acs_tables(spec, rho)
    S = spec.n_states
    home = mesh.devices[0]

    def compose(a, b):
        return tp.tropical_matmul(a, b, mm, use_kernel)

    def span(i):
        return blocks[i * t_loc:(i + 1) * t_loc].to(mesh.devices[i])

    # 1. formation and the local prefix scan; the span products gathered
    ms, prefixes = [], []
    for i in range(n_dev):
        m = tp.transfer_matrices(span(i), tables, precision, tile,
                                 use_kernel=use_kernel)
        ms.append(m)
        prefixes.append(tp.associative_scan(compose, m))
    tots = torch.stack([p[-1].to(home) for p in prefixes])  # (n_dev, F, S, S)

    # 2. the exclusive fold over the shards before each, entry metrics,
    # recovery
    eye = tp.tropical_identity(S, device=home).expand(F, S, S)
    lam0 = init_metric(F, S, initial_state, device=home)
    entries, lam_fins, phis = [], [], []
    for i, dev in enumerate(mesh.devices):
        acc = eye
        for d in range(i):
            acc = compose(acc, tots[d])
        v0 = (lam0[:, :, None] + acc).amax(dim=-2).to(dev)  # (F, S)
        entry = tp.entry_from_prefix(prefixes[i], v0)  # (n_loc, F, S)
        tiles = tp.tiled_blocks(span(i), tile)
        lam_fin, phi = forward_fused(
            tiles.reshape(tile, n_loc * F, -1), entry.reshape(n_loc * F, S),
            tables, precision, use_kernel, pack_survivors,
        )
        entries.append(entry)
        lam_fins.append(lam_fin.reshape(n_loc, F, S))
        phis.append(phi)
    if final_state is None:
        fs = lam_fins[-1][-1].to(home).argmax(dim=-1)
    else:
        fs = torch.full((F,), final_state, dtype=torch.int64, device=home)

    # 3. the boundary states: the local reverse scan beside the fold over
    # the shards after each, then the traceback of each shard's tiles
    starts = []
    for i, dev in enumerate(mesh.devices):
        suffix = tp.associative_scan(
            lambda a, b: compose(b, a), ms[i], reverse=True)
        acc2 = eye
        for d in range(n_dev - 1, i, -1):
            acc2 = compose(tots[d], acc2)
        w_end = acc2.gather(-1, fs[:, None, None].expand(F, S, 1))[..., 0]
        v = (suffix + w_end.to(dev)[None, :, None, :]).amax(dim=-1)
        starts.append((entries[i] + v).argmax(dim=-1))  # (n_loc, F)
    outs = []
    for i, dev in enumerate(mesh.devices):
        dev_exit = fs if i == n_dev - 1 else starts[i + 1][0]
        exits = torch.cat([starts[i][1:], dev_exit.to(dev)[None]], dim=0)
        bits = traceback(phis[i], exits.reshape(n_loc * F), tables)
        outs.append(bits.reshape(n_loc, F, tile * rho).permute(1, 0, 2)
                    .reshape(F, t_loc * rho).to(home))
    return torch.cat(outs, dim=1)
