"""GPipe-style pipeline parallelism over a ``pipe`` mesh axis (DESIGN.md §5),
the port of the reference's ``distributed/pipeline.py``.

The layer stack is split into ``pipe`` stages; microbatches stream
through, each stage running its local layers and handing its activations
to the next stage.  The bubble fraction is the standard (P-1)/(M+P-1).

The reference runs the schedule under ``shard_map``: a ``lax.scan`` over
t = 0 .. M+P-2 in which every stage calls ``stage_fn`` at every step,
masks the bubble steps' results, and moves activations on with
``ppermute``.  Here the schedule runs step by step on the host over the
same t: stage i takes microbatch t - i when 0 <= t - i < M, from the
queue (stage 0) or from what stage i - 1 handed it at step t - 1; its
output goes to stage i + 1 with a ``.to()`` of that stage's device (the
reference's ``ppermute``, recorded as a collective-permute), and the
last stage collects its finished microbatch.  Inactive (t, stage) pairs
are skipped rather than computed and masked: their outputs are discarded
in the reference.  The output is the last stage's microbatches in order,
on ``x``'s device (the reference's masked ``psum`` replicates them).

The stage function is user-supplied (params_stage, x) -> x, so any of the
repro models' layer stacks can ride the pipeline.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import sharding as shd

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def _stage_params(stage_params, i: int, shard: int, device):
    """Stage i's slice of the stacked stage parameters: a tensor's
    ``[i]``, or the piece of a ``ShardedTensor`` sharded over the pipe
    axis (leading dim 1) that ``shard`` holds."""
    def one(_, leaf):
        if isinstance(leaf, shd.ShardedTensor):
            return leaf.pieces[shard][0]
        return leaf[i].to(device)

    return shd._tree_map(one, stage_params)


def pipeline_apply(stage_fn: Callable, mesh, n_microbatches: int, axis: str = "pipe"):
    """Build ``pipelined_apply(stage_params, x) -> y``.

    stage_params: a tree whose leaves have leading dim n_stages (or are
    ``ShardedTensor``s with spec ``P(axis)``); x: (batch, ...) the global
    batch, split into ``n_microbatches``.  Stage i runs on the device of
    the shard at coordinate i of ``axis``."""
    n_stages = mesh.shape[axis]
    shards = [mesh.shard_at(**{axis: i}) for i in range(n_stages)]
    devices = [mesh.devices[s] for s in shards]

    def apply(stage_params, x):
        if x.shape[0] % n_microbatches:
            raise ValueError(
                f"batch of {x.shape[0]} does not split into {n_microbatches} microbatches")
        params = [_stage_params(stage_params, i, shards[i], devices[i])
                  for i in range(n_stages)]
        mbs = x.reshape((n_microbatches, -1) + tuple(x.shape[1:]))
        bufs = [None] * n_stages  # the activation entering each stage
        out = [None] * n_microbatches
        for t in range(n_microbatches + n_stages - 1):
            nxt = [None] * n_stages
            for i in range(n_stages):
                m = t - i
                if not 0 <= m < n_microbatches:
                    continue  # a bubble step: the reference's masked result
                x_in = mbs[m].to(devices[0]) if i == 0 else bufs[i]
                y = stage_fn(params[i], x_in)
                if i == n_stages - 1:
                    out[m] = y
                else:
                    shd.record_collective("collective-permute", n_stages, y)
                    nxt[i + 1] = y.to(devices[i + 1])
            bufs = nxt
        return torch.cat([y.to(x.device) for y in out], dim=0)

    return apply
