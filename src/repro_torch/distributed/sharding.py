"""Sharding rules: parameter, optimiser, batch and cache specs per arch, and
the sharded tensors they lay out, the port of the reference's
``distributed/sharding.py``.

Strategy (DESIGN.md §5), rule for rule the reference's:
  * ZeRO-3/FSDP: every weight is sharded over the ``data`` axis on one
    large dim AND over ``model`` on the TP dim (head/ffn/expert);
  * a dim is only sharded if divisible by the axis size -- otherwise that
    dim stays replicated (``_maybe``), which keeps odd head counts
    (qwen's 40 q-heads, hymba's 50 SSM heads, smollm's 3 kv heads) legal
    without uneven pieces;
  * MoE experts go over ``model`` (EP) when E divides it, else the expert
    FFN dim is TP-sharded;
  * batch goes over (pod, data); when the batch does not divide (batch 1,
    long-context decode) the cache sequence dim is context-parallel.

``P`` is the port's ``PartitionSpec``: a tuple with one entry a dim,
``None``, an axis name or a tuple of axis names.  A
:class:`ShardedTensor` holds the global shape, the spec and one piece a
shard of a ``launch.mesh.Mesh``: a dim sharded over a tuple of axes is
cut in the flattened order of that tuple, first axis major, as GSPMD
cuts it, and a shard whose spec leaves an axis out holds a replica.
``shard(x, mesh, spec)`` lays a tensor out, ``gather`` puts it back
together; the pieces of a dim that does not divide are never uneven:
the specs leave such a dim replicated, and ``shard`` refuses one.

``constrain`` and ``kv_cache_constraint`` resolve their axes against the
ambient mesh (``with mesh:``) as the reference does: names the mesh
lacks and axes that do not divide are dropped.  They return ``x``
itself: the reference pins a layout for its compiler, and the port,
whose shards run one after another (``distributed/spmd.py``), has no
compiler to pin one for.  ``constraint_spec`` and ``kv_cache_spec`` give
the resolution, and ``constraint_log()`` records every resolution the
model's call sites make under a mesh.

``collective_log()`` records the collectives the port makes (the
sharded steps' gathers and reductions, the pipeline's moves): kind,
group size, dtype, shape and result bytes, which ``hlocount.analyze``
counts and ``roofline.parse_collectives`` reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, List, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch.mesh import Mesh, current_mesh, dp_axes

__all__ = [
    "P",
    "NamedSharding",
    "ShardedTensor",
    "axis_size",
    "param_specs",
    "batch_specs",
    "cache_partition_specs",
    "named",
    "train_state_shardings",
    "constrain",
    "constraint_spec",
    "constraint_log",
    "kv_cache_constraint",
    "kv_cache_spec",
    "shard",
    "gather",
    "shard_tree",
    "gather_tree",
    "spec_tree",
    "collective_log",
    "record_collective",
]


class P(tuple):
    """A partition spec: one entry a dim (``None``, an axis name, or a
    tuple of axis names); trailing dims left out are replicated.  A tuple
    of one name is that name and an empty tuple is ``None``, as JAX
    spells them."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: P


# -- trees -------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields") and not isinstance(node, P)


def _tree_map(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over nested dicts and NamedTuples;
    a ``P``, a ``NamedSharding`` and a ``ShardedTensor`` are leaves.
    Dict keys are visited in sorted order (``jax.tree``'s)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest), path=path + (k,))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            _tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                      path=path + (f,))
            for f in tree._fields))
    return fn(path, tree, *rest)


def _leaves(tree) -> list:
    out = []
    _tree_map(lambda _, leaf: out.append(leaf), tree)
    return out


# -- ambient constraints ------------------------------------------------------

_LOGS = threading.local()


def _active(name: str) -> list:
    return getattr(_LOGS, name, None) or []


@contextlib.contextmanager
def _logging(name: str):
    log: List[Any] = []
    stack = getattr(_LOGS, name, None)
    if stack is None:
        stack = []
        setattr(_LOGS, name, stack)
    stack.append(log)
    try:
        yield log
    finally:
        stack.remove(log)


def constraint_log():
    """``with constraint_log() as log:`` collects ``(shape, spec)`` for
    every ``constrain`` that resolves against an ambient mesh."""
    return _logging("constraints")


def constraint_spec(shape, *axes, mesh: Optional[Mesh] = None) -> Optional[P]:
    """The spec ``constrain(x, *axes)`` resolves to for a tensor of
    ``shape`` under ``mesh`` (default: the ambient mesh), or None with no
    mesh.  Axis names the mesh lacks, and dims the axis size does not
    divide, are dropped (the reference's rule)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    names = set(mesh.axis_names)

    def ok(a, dim):
        flat = tuple(f for f in (a if isinstance(a, tuple) else (a,)) if f in names)
        if not flat:
            return None
        if dim % math.prod(mesh.shape[f] for f in flat):
            return None
        return flat if len(flat) > 1 else flat[0]

    resolved = [None if a is None else ok(a, shape[i]) for i, a in enumerate(axes)]
    resolved += [None] * (len(shape) - len(resolved))
    return P(*resolved)


def constrain(x, *axes):
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh: resolves the axes (``constraint_spec``) and returns ``x``
    itself (module docstring).  With no mesh it does nothing."""
    spec = constraint_spec(tuple(x.shape), *axes)
    if spec is not None:
        for log in _active("constraints"):
            log.append((tuple(x.shape), spec))
    return x


def _kv_axes(mesh, n_kv_heads: int) -> tuple:
    """Batch over (pod, data); the kv heads over "model" when they divide
    it, else the sequence (the context-parallel cache)."""
    if n_kv_heads % mesh.shape["model"] == 0:
        return (("pod", "data"), None, "model", None)
    return (("pod", "data"), "model", None, None)


def kv_cache_spec(shape, n_kv_heads: int, head_dim: int,
                  mesh: Optional[Mesh] = None) -> Optional[P]:
    """The spec a per-layer KV cache slice (B, Sc, KV, hd) is pinned to
    (``_kv_axes``), or None with no mesh or no "model" axis."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return None
    return constraint_spec(shape, *_kv_axes(mesh, n_kv_heads), mesh=mesh)


def kv_cache_constraint(x, n_kv_heads: int, head_dim: int):
    """Pin a per-layer KV cache slice to its canonical sharding under the
    ambient mesh (``kv_cache_spec``); returns ``x`` itself."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return x
    return constrain(x, *_kv_axes(mesh, n_kv_heads))


# -- spec rules ----------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _size(mesh, axis) -> int:
    return math.prod(axis_size(mesh, a) for a in (axis if isinstance(axis, tuple) else (axis,)))


def _maybe(mesh, axis, dim: int):
    """Shard ``dim`` over ``axis`` only when divisible (else replicate)."""
    if axis is None:
        return None
    return axis if _size(mesh, axis) > 1 and dim % _size(mesh, axis) == 0 else None


def param_specs(cfg: ArchConfig, mesh, params_shape) -> dict:
    """The spec tree matching the parameter tree.  ``params_shape`` is a
    tree of anything with ``.shape`` (``meta`` tensors in the dry run)."""
    dp = dp_axes(mesh)
    fsdp = dp[-1] if dp else None  # intra-pod data axis carries FSDP

    def leaf_spec(keys, leaf):
        name = keys[-1]
        shape = tuple(leaf.shape)
        nd = len(shape)

        def mk(*axes):
            axes = list(axes) + [None] * (nd - len(axes))
            return P(*[_maybe(mesh, a, shape[i]) if a else None
                       for i, a in enumerate(axes)])

        if name == "embed":  # (V, D)
            return mk("model", fsdp)
        if name == "lm_head":  # (D, V)
            return mk(fsdp, "model")
        if name == "final_norm":
            return P()
        if "moe" in keys:
            ep = cfg.n_experts % axis_size(mesh, "model") == 0
            if name == "router":  # (L, D, E)
                return mk(None, fsdp, None)
            if name in ("w_gate", "w_up"):  # (L, E, D, F)
                return (mk(None, "model", fsdp, None) if ep
                        else mk(None, None, fsdp, "model"))
            if name == "w_down":  # (L, E, F, D)
                return (mk(None, "model", None, fsdp) if ep
                        else mk(None, None, "model", fsdp))
        if "attn" in keys:
            if name in ("wq", "wk", "wv"):  # (L, D, H*hd)
                return mk(None, fsdp, "model")
            if name == "wo":  # (L, H*hd, D)
                return mk(None, "model", fsdp)
            if name in ("bq", "bk", "bv"):  # (L, H*hd)
                return mk(None, "model")
        if "ssm" in keys:
            if name == "in_proj":  # (L, D, E_in)
                return mk(None, fsdp, "model")
            if name == "out_proj":  # (L, d_inner, D)
                return mk(None, "model", fsdp)
            if name == "conv_w":  # (L, W, CD)
                return mk(None, None, "model")
            if name in ("conv_b", "norm"):  # (L, CD) / (L, d_inner)
                return mk(None, "model")
            if name in ("A_log", "D", "dt_bias"):  # (L, H)
                return mk(None, "model")
        if "mlp" in keys or "res" in keys:
            if name in ("w_gate", "w_up"):  # (L, D, F)
                return mk(None, fsdp, "model")
            if name == "w_down":  # (L, F, D)
                return mk(None, "model", fsdp)
        if name in ("norm1", "norm2", "beta_a", "beta_m"):  # (L, D)
            return mk(None, fsdp)
        return P()  # replicate anything unrecognized

    return _tree_map(leaf_spec, params_shape)


def batch_specs(cfg: ArchConfig, mesh, cell: ShapeCell) -> dict:
    """Specs of the input batch dict of this cell."""
    dp = dp_axes(mesh)
    bspec = dp if cell.global_batch % _size(mesh, dp) == 0 else None
    out = {"tokens": P(bspec, None)}
    if cell.kind == "train":
        out["labels"] = P(bspec, None)
    if cfg.prefix_len and cell.kind != "decode":
        out["prefix_embeds"] = P(bspec, None, None)
    return out


def cache_partition_specs(cfg: ArchConfig, mesh, batch: int) -> dict:
    """Decode-cache specs.

    batch: sharded over (pod, data) when divisible, else the cache
    sequence goes context-parallel over ``data``.  kv heads: sharded
    over ``model`` when divisible; otherwise the SEQUENCE dim takes the
    ``model`` axis (a context-parallel cache)."""
    dp = dp_axes(mesh)
    batch_ok = batch % _size(mesh, dp) == 0
    b_ax = dp if batch_ok else None
    model = axis_size(mesh, "model")
    kv_ok = cfg.n_kv_heads > 0 and cfg.n_kv_heads % model == 0
    specs = {"pos": P()}
    if cfg.n_heads > 0:
        if kv_ok:
            seq_ax = None if batch_ok else "data"
            kv_ax = "model"
        else:
            seq_ax = "model" if batch_ok else ("data", "model")
            kv_ax = None
        # (L, B, Sc, KV, hd)
        specs["k"] = P(None, b_ax, seq_ax, kv_ax, None)
        specs["v"] = P(None, b_ax, seq_ax, kv_ax, None)
        if cfg.kv_cache_dtype == "int8":  # (L, B, Sc, KV) dequant scales
            specs["k_scale"] = P(None, b_ax, seq_ax, kv_ax)
            specs["v_scale"] = P(None, b_ax, seq_ax, kv_ax)
    if cfg.family in ("ssm", "hybrid"):
        # (L, B, H, P, N): heads over model when divisible, else the SSD
        # head_dim P
        h_ax = "model" if cfg.ssm_heads % model == 0 else None
        p_ax = None if h_ax else ("model" if cfg.ssm_head_dim % model == 0 else None)
        specs["ssm"] = P(None, b_ax, h_ax, p_ax, None)
        cd = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        specs["conv"] = P(None, b_ax, None, "model" if cd % model == 0 else None)
    return specs


def _fix_divisibility(spec_tree, shape_tree, mesh):
    """Drop any spec axis that does not divide its dim (safety net)."""

    def fix(_, spec, leaf):
        if not isinstance(spec, P):
            return spec
        return P(*[None if ax is None or leaf.shape[i] % _size(mesh, ax) else ax
                   for i, ax in enumerate(spec)])

    return _tree_map(fix, spec_tree, shape_tree)


def named(mesh, spec_tree):
    return _tree_map(lambda _, s: NamedSharding(mesh, s), spec_tree)


def train_state_shardings(cfg: ArchConfig, mesh, params_shape, opt_shape):
    """(param_shardings, opt_shardings): opt m/v inherit the param specs."""
    from repro_torch.optim.adamw import OptState

    pspecs = param_specs(cfg, mesh, params_shape)
    pspecs = _fix_divisibility(pspecs, params_shape, mesh)
    opt_specs = OptState(step=P(), m=pspecs, v=pspecs)
    return named(mesh, pspecs), named(mesh, opt_specs)


# -- collectives ------------------------------------------------------------------

def collective_log():
    """``with collective_log() as log:`` collects one dict a collective
    the port makes: ``kind`` (the reference's names: all-gather,
    all-reduce, collective-permute), ``group_size``, ``dtype``,
    ``shape`` and ``result_bytes``."""
    return _logging("collectives")


def record_collective(kind: str, group_size: int, t: torch.Tensor) -> None:
    """Note a collective whose result is ``t`` (its shape and dtype)."""
    if group_size <= 1:
        return
    rec = {"kind": kind, "group_size": int(group_size),
           "dtype": str(t.dtype).replace("torch.", ""), "shape": tuple(t.shape),
           "result_bytes": t.numel() * t.element_size()}
    for log in _active("collectives"):
        log.append(rec)


# -- sharded tensors ------------------------------------------------------------------

def _piece_slices(shape, spec: P, mesh: Mesh, shard: int) -> tuple:
    """The slices of a global tensor of ``shape`` that ``shard`` holds."""
    coords = mesh.coords(shard)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(slice(None))
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = _size(mesh, axes)
        if dim % n:
            raise ValueError(
                f"dim {i} of {tuple(shape)} does not divide over {axes} ({n} pieces): "
                "the port makes no uneven pieces")
        idx = 0
        for a in axes:
            idx = idx * axis_size(mesh, a) + coords.get(a, 0)
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def _n_pieces(spec: P, mesh: Mesh) -> int:
    return math.prod(_size(mesh, ax) for ax in spec if ax is not None)


@dataclasses.dataclass(eq=False)
class ShardedTensor:
    """A tensor laid out over a mesh: ``pieces[i]`` is shard i's, on
    ``mesh.devices[i]``; ``shape`` and ``dtype`` are the global tensor's."""

    shape: tuple
    dtype: torch.dtype
    spec: P
    mesh: Mesh
    pieces: list

    @property
    def n_pieces(self) -> int:
        """Distinct pieces (the shard count over the replicas)."""
        return _n_pieces(self.spec, self.mesh)

    def slices(self, shard: int) -> tuple:
        return _piece_slices(self.shape, self.spec, self.mesh, shard)


def shard(x: torch.Tensor, mesh: Mesh, spec) -> ShardedTensor:
    """Lay ``x`` out over ``mesh`` per ``spec``: shard i owns a copy of
    its slice on ``mesh.devices[i]``."""
    spec = P(*spec) if not isinstance(spec, P) else spec
    pieces = []
    for i, dev in enumerate(mesh.devices):
        view = x[_piece_slices(x.shape, spec, mesh, i)]
        pieces.append(torch.empty(view.shape, dtype=x.dtype, device=dev).copy_(view))
    return ShardedTensor(tuple(x.shape), x.dtype, spec, mesh, pieces)


def gather(st: ShardedTensor, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: shard 0's), each distinct
    piece copied in once; recorded as an all-gather over the pieces."""
    dev = st.mesh.devices[0] if device is None else torch.device(device)
    out = torch.empty(st.shape, dtype=st.dtype, device=dev)
    seen = set()
    for i, piece in enumerate(st.pieces):
        sl = st.slices(i)
        key = tuple((s.start, s.stop) for s in sl)
        if key not in seen:
            seen.add(key)
            out[sl].copy_(piece)
    record_collective("all-gather", len(seen), out)
    return out


def spec_tree(tree):
    """The spec tree of a tree of ``NamedSharding``."""
    return _tree_map(lambda _, s: s.spec if isinstance(s, NamedSharding) else s, tree)


def shard_tree(tree, shardings, mesh: Optional[Mesh] = None):
    """``shard`` over a tree of tensors and the matching tree of
    ``NamedSharding`` (or of ``P`` with ``mesh``)."""
    def one(_, x, s):
        if isinstance(s, NamedSharding):
            return shard(x, s.mesh, s.spec)
        return shard(x, mesh, s)

    return _tree_map(one, tree, shardings)


def gather_tree(tree, device=None):
    """``gather`` over every sharded leaf of a tree."""
    return _tree_map(
        lambda _, x: gather(x, device) if isinstance(x, ShardedTensor) else x, tree)
