"""The sharded train, prefill and decode steps on a ``launch.mesh.Mesh``: the
port's counterpart of ``jax.jit(step, in_shardings=..., out_shardings=...)``
(``src/repro/launch/dryrun.py:107-141``, ``tests/test_distributed.py``).

The state is held as ``ShardedTensor`` leaves (``distributed/sharding.py``):
parameters and AdamW moments per ``train_state_shardings``, the decode
cache per ``cache_partition_specs``; each logical shard owns exactly its
pieces.  A step:

  * gathers the parameters at use (ZeRO-3) onto each data-parallel
    group's device, one all-gather a leaf;
  * cuts the batch over the dp axes per ``batch_specs``: group g takes the
    g-th block of rows (the flattened (pod, data) index), and a batch
    that does not divide is one group;
  * runs each group's rows whole, one group after another: the ``model``
    axis shards storage and the cache, and sets the EP/TP choice of the
    ambient mesh, but it does not split a matmul's compute (a departure
    from GSPMD, which splits it over ``model``);
  * reduces the groups' f32 gradients in group order, clips by the global
    norm of the whole reduced gradient, and lets each shard update its
    own pieces with ``optim/adamw.py::adamw_update``;
  * writes prefill's and decode's cache back into its spec's pieces,
    context-parallel forms included.

Global-batch semantics, as the reference's sharded program computes them:
the cross-entropy is the token sum over the whole (micro)batch over its
global token count (each group divides by that count, so the groups'
losses and gradients add up to the global mean); the MoE configs route
and take their aux loss over the global token set, so their forward runs
the whole (micro)batch as one group.  On the dense, SSM and hybrid
configs one group's forward is exactly one of ``train.step``'s
microbatches, so the sharded step with one microbatch equals
``make_train_step(cfg, microbatches=dp size)`` bit for bit when every
label counts (the groups' counts are then equal, and dividing by the
global count is the microbatch mean over the group count, exact in
binary floating point).

``shard_program(..., shard=i)`` runs what shard i runs of one step: the
gathers it takes part in, its group's rows (on a MoE config too: the
global routing statistics are then the group's, so its values are not
the step's, but its operations and bytes are), the reductions and the
update of its own pieces.  ``hlocount.analyze`` counts it for the dry
run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import Mesh, dp_axes
from repro_torch.models import lm
from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_update,
    cosine_schedule,
    global_norm,
    tree_map,
)

__all__ = [
    "shard_params",
    "shard_train_state",
    "shard_cache",
    "shard_bytes",
    "make_sharded_train_step",
    "make_sharded_prefill_step",
    "make_sharded_decode_step",
]


def shard_params(params, cfg: ArchConfig, mesh: Mesh):
    """The parameter tree laid out per ``train_state_shardings``."""
    p_sh, _ = shd.train_state_shardings(cfg, mesh, params, None)
    return shd.shard_tree(params, p_sh)


def shard_train_state(params, opt_state: OptState, cfg: ArchConfig, mesh: Mesh):
    """(params, opt_state) laid out per ``train_state_shardings``: the
    moments inherit the parameters' specs, the step is replicated."""
    p_sh, o_sh = shd.train_state_shardings(cfg, mesh, params, opt_state)
    return shd.shard_tree(params, p_sh), shd.shard_tree(opt_state, o_sh)


def _cache_batch(cache: dict) -> int:
    return next(v.shape[1] for k, v in cache.items() if k != "pos")


def shard_cache(cache: dict, cfg: ArchConfig, mesh: Mesh) -> dict:
    """The decode cache laid out per ``cache_partition_specs``.  A dim its
    spec does not divide stays replicated (``_fix_divisibility``), where
    GSPMD pads it."""
    specs = shd.cache_partition_specs(cfg, mesh, _cache_batch(cache))
    specs = shd._fix_divisibility(specs, cache, mesh)
    return shd.shard_tree(cache, specs, mesh)


def shard_bytes(tree, shard: int = 0) -> int:
    """Bytes a shard holds of a tree of ``ShardedTensor``."""
    return sum(st.pieces[shard].numel() * st.pieces[shard].element_size()
               for st in shd._leaves(tree) if isinstance(st, shd.ShardedTensor))


# -- groups -------------------------------------------------------------------

def _n_groups(mesh: Mesh, cfg: ArchConfig, n_rows: int, kind: str) -> int:
    """Data-parallel groups a batch of ``n_rows`` splits into: the dp
    size when ``batch_specs`` shards the batch, else 1."""
    spec = shd.batch_specs(cfg, mesh, ShapeCell("", 1, n_rows, kind))["tokens"]
    return shd._size(mesh, spec[0]) if spec[0] else 1


def _group_of(mesh: Mesh, shard: int, n_groups: int) -> int:
    if n_groups == 1:
        return 0
    c = mesh.coords(shard)
    g = 0
    for a in dp_axes(mesh):
        g = g * mesh.shape[a] + c[a]
    return g


def _group_shards(mesh: Mesh, g: int, n_groups: int) -> list:
    return [s for s in range(mesh.size) if _group_of(mesh, s, n_groups) == g]


def _rows(n_rows: int, g: int, n_groups: int) -> slice:
    step = n_rows // n_groups
    return slice(g * step, (g + 1) * step)


def _box(st: shd.ShardedTensor, shards) -> tuple:
    """The smallest box of the global tensor covering ``shards``' pieces."""
    sls = [st.slices(s) for s in shards]
    return tuple(slice(min(sl[d].indices(n)[0] for sl in sls),
                       max(sl[d].indices(n)[1] for sl in sls))
                 for d, n in enumerate(st.shape))


def _gather_part(st: shd.ShardedTensor, shards, device) -> torch.Tensor:
    """The part of ``st`` that ``shards`` hold together (a box), on
    ``device``; recorded as an all-gather over its distinct pieces."""
    box = _box(st, shards)
    out = torch.empty([b.stop - b.start for b in box], dtype=st.dtype, device=device)
    seen = set()
    for s in shards:
        sl = st.slices(s)
        rel = tuple(slice(a.indices(n)[0] - b.start, a.indices(n)[1] - b.start)
                    for a, b, n in zip(sl, box, st.shape))
        key = tuple((r.start, r.stop) for r in rel)
        if key not in seen:
            seen.add(key)
            out[rel].copy_(st.pieces[s])
    shd.record_collective("all-gather", len(seen), out)
    return out


def _put_part(st: shd.ShardedTensor, part: torch.Tensor, shards, pieces: list) -> None:
    """Write ``part`` (the box of ``shards``) back as those shards' pieces."""
    box = _box(st, shards)
    for s in shards:
        sl = st.slices(s)
        rel = tuple(slice(a.indices(n)[0] - b.start, a.indices(n)[1] - b.start)
                    for a, b, n in zip(sl, box, st.shape))
        dev = st.mesh.devices[s]
        view = part[rel]
        pieces[s] = torch.empty(view.shape, dtype=view.dtype, device=dev).copy_(view)


def _regroup(template, pieces_by_shard):
    """ShardedTensors of ``template``'s layout from per-shard piece trees."""
    def one(path, st):
        pieces = []
        for tree in pieces_by_shard:
            node = tree
            for k in path:
                node = node[k] if isinstance(node, dict) else getattr(node, k)
            pieces.append(node)
        return shd.ShardedTensor(st.shape, pieces[0].dtype, st.spec, st.mesh, pieces)

    return shd._tree_map(one, template)


def _pieces(tree, shard: int):
    return shd._tree_map(lambda _, st: st.pieces[shard], tree)


# -- train -------------------------------------------------------------------------

class ShardedTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on sharded trees; ``batch`` holds whole (global-batch) tensors.
    ``microbatches`` slices the global batch as ``train.step``'s does;
    each slice is then cut over the dp groups.  The metrics are the last
    slice's (its global cross-entropy and aux loss) with the AdamW stats
    and the step's loss."""

    def __init__(self, cfg: ArchConfig, mesh: Mesh,
                 opt_cfg: Optional[AdamWConfig] = None, microbatches: int = 1):
        from repro_torch.train.step import _grad_fn

        self.cfg, self.mesh = cfg, mesh
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.lr_fn = cosine_schedule(self.opt_cfg)
        self.microbatches = microbatches
        self.grad_fn = _grad_fn(cfg)

    def _split(self, batch):
        n = batch["tokens"].shape[0]
        if n % self.microbatches:
            raise ValueError(
                f"batch of {n} does not split into {self.microbatches} microbatches")
        size = n // self.microbatches
        groups = _n_groups(self.mesh, self.cfg, n, "train")
        if size % groups:
            groups = 1
        return size, groups

    def _count(self, labels, device, n_groups):
        """The global count of unmasked labels (an all-reduce of the
        groups' counts)."""
        count = (labels >= 0).to(torch.float32).sum().to(device)
        shd.record_collective("all-reduce", n_groups, count)
        return count

    def _group_grads(self, full, batch, rows, n_tokens, device):
        part = {k: v[rows].to(device) for k, v in batch.items()}
        return self.grad_fn(full, part, n_tokens.to(device))

    def _reduce(self, grads, n_groups):
        for g in shd._leaves(grads):
            shd.record_collective("all-reduce", n_groups, g)

    def _update(self, shard, grads, gnorm, params, opt_state):
        """Shard ``shard``'s AdamW update of its own pieces."""
        dev = self.mesh.devices[shard]
        g_s = shd._tree_map(lambda _, g, st: g[st.slices(shard)].to(dev), grads, params)
        state = OptState(step=opt_state.step.pieces[shard], m=_pieces(opt_state.m, shard),
                         v=_pieces(opt_state.v, shard))
        return adamw_update(g_s, state, _pieces(params, shard), self.opt_cfg, self.lr_fn,
                            grad_norm=gnorm.to(dev))

    def __call__(self, params, opt_state, batch):
        mesh, cfg = self.mesh, self.cfg
        size, groups = self._split(batch)
        dev0 = mesh.devices[0]
        # the MoE configs route over the global token set: one group
        parts = 1 if cfg.n_experts else groups
        devs = [mesh.devices[_group_shards(mesh, g, parts)[0]] for g in range(parts)]
        full = {}
        for d in devs:
            if d not in full:
                full[d] = shd.gather_tree(params, d)
        grads = tree_map(lambda st: torch.zeros(st.shape, dtype=torch.float32, device=dev0),
                         params)
        loss = 0.0
        with mesh:
            for i in range(self.microbatches):
                sl = slice(i * size, (i + 1) * size)
                mb = {k: v[sl] for k, v in batch.items()}
                n_tokens = self._count(mb["labels"], dev0, groups)
                ce = aux = 0.0
                for g, d in enumerate(devs):
                    loss_g, m, g_grads = self._group_grads(
                        full[d], mb, _rows(size, g, parts), n_tokens, d)
                    grads = tree_map(lambda a, b: a + b.to(dev0), grads, g_grads)
                    loss = loss + loss_g.to(dev0)
                    ce = ce + m["ce_loss"].to(dev0)
                    aux = m["aux_loss"].to(dev0)
            self._reduce(grads, parts)
            grads = tree_map(lambda g: g / self.microbatches, grads)
            loss = loss / self.microbatches
            gnorm = global_norm(grads)
            outs = [self._update(s, grads, gnorm, params, opt_state)
                    for s in range(mesh.size)]
        new_p = _regroup(params, [o[0] for o in outs])
        new_opt = OptState(
            step=_regroup(opt_state.step, [o[1].step for o in outs]),
            m=_regroup(opt_state.m, [o[1].m for o in outs]),
            v=_regroup(opt_state.v, [o[1].v for o in outs]),
        )
        metrics = {"ce_loss": ce, "aux_loss": aux, **outs[0][2], "loss": loss}
        return new_p, new_opt, metrics

    def shard_program(self, params, opt_state, batch, shard: int = 0):
        """What ``shard`` runs of one step (module docstring); returns its
        new pieces and AdamW stats."""
        mesh = self.mesh
        size, groups = self._split(batch)
        dev = mesh.devices[shard]
        g = _group_of(mesh, shard, groups)
        full = shd.gather_tree(params, dev)
        grads = tree_map(lambda st: torch.zeros(st.shape, dtype=torch.float32, device=dev),
                         params)
        with mesh:
            for i in range(self.microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                rows = _rows(size, g, groups)
                n_tokens = self._count(mb["labels"][rows], dev, groups)
                _, _, g_grads = self._group_grads(full, mb, rows, n_tokens, dev)
                grads = tree_map(torch.add, grads, g_grads)
            self._reduce(grads, groups)
            grads = tree_map(lambda t: t / self.microbatches, grads)
            return self._update(shard, grads, global_norm(grads), params, opt_state)


def make_sharded_train_step(cfg: ArchConfig, mesh: Mesh,
                            opt_cfg: Optional[AdamWConfig] = None,
                            microbatches: int = 1) -> ShardedTrainStep:
    return ShardedTrainStep(cfg, mesh, opt_cfg, microbatches)


# -- serve ---------------------------------------------------------------------------

class _ShardedServeStep:
    """Prefill or decode on sharded parameters and a sharded cache: each
    dp group gathers the parameters and its rows of the cache, runs
    ``lm.prefill`` / ``lm.decode_step`` on its rows and writes the new
    cache back into its shards' pieces.  Returns (logits of every row on
    shard 0's device, the new sharded cache)."""

    def __init__(self, cfg: ArchConfig, mesh: Mesh, kind: str):
        self.cfg, self.mesh, self.kind = cfg, mesh, kind

    def _run(self, full, cache_part, inputs):
        if self.kind == "prefill":
            return lm.prefill(full, self.cfg, inputs["tokens"], cache_part,
                              inputs.get("prefix_embeds"))
        return lm.decode_step(full, self.cfg, inputs["tokens"], cache_part)

    def _group(self, params, cache, inputs, g, groups, shards, pieces, full=None):
        dev = self.mesh.devices[shards[0]]
        if full is None:
            full = shd.gather_tree(params, dev)
        rows = _rows(inputs["tokens"].shape[0], g, groups)
        part = {k: _gather_part(st, shards, dev) for k, st in cache.items()}
        logits, new = self._run(full, part, {k: v[rows].to(dev) for k, v in inputs.items()})
        for k, st in cache.items():
            _put_part(st, new[k], shards, pieces[k])
        return logits

    def __call__(self, params, cache, inputs):
        if self.kind == "decode":
            inputs = {"tokens": inputs}
        mesh = self.mesh
        groups = _n_groups(mesh, self.cfg, inputs["tokens"].shape[0], self.kind)
        pieces = {k: [None] * mesh.size for k in cache}
        full = {}
        logits = []
        with mesh:
            for g in range(groups):
                shards = _group_shards(mesh, g, groups)
                dev = mesh.devices[shards[0]]
                if dev not in full:
                    full[dev] = shd.gather_tree(params, dev)
                logits.append(self._group(params, cache, inputs, g, groups, shards,
                                          pieces, full[dev]).to(mesh.devices[0]))
        out = torch.cat(logits, dim=0)
        shd.record_collective("all-gather", groups, out)
        new_cache = {k: shd.ShardedTensor(st.shape, pieces[k][0].dtype, st.spec, mesh,
                                          pieces[k]) for k, st in cache.items()}
        return out, new_cache

    def shard_program(self, params, cache, inputs, shard: int = 0):
        """What ``shard`` runs of one step: the parameters' and its
        group's cache gathers, its group's rows and its own pieces."""
        if self.kind == "decode":
            inputs = {"tokens": inputs}
        mesh = self.mesh
        groups = _n_groups(mesh, self.cfg, inputs["tokens"].shape[0], self.kind)
        g = _group_of(mesh, shard, groups)
        shards = [shard] + [s for s in _group_shards(mesh, g, groups) if s != shard]
        pieces = {k: [None] * mesh.size for k in cache}
        with mesh:
            return self._group(params, cache, inputs, g, groups, shards, pieces)


def make_sharded_prefill_step(cfg: ArchConfig, mesh: Mesh) -> _ShardedServeStep:
    """prefill(params, cache, batch) -> (last logits (B, V) f32, cache), on
    sharded parameters and cache (``make_prefill_step``'s contract)."""
    return _ShardedServeStep(cfg, mesh, "prefill")


def make_sharded_decode_step(cfg: ArchConfig, mesh: Mesh) -> _ShardedServeStep:
    """decode(params, cache, tokens (B, 1)) -> (logits (B, V) f32, cache),
    on sharded parameters and cache (``make_decode_step``'s contract)."""
    return _ShardedServeStep(cfg, mesh, "decode")
