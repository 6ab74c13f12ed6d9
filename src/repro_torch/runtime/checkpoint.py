"""Checkpoints: the training tree (params + optimiser state) and the
serving engine's session table, the port of the reference's
``runtime/checkpoint.py`` in the same on-disk format.

Layout::

    <dir>/step_000000123/
        manifest.json        # step, keys, shapes/dtypes, extra, status
        arrays.npz           # flat arrays keyed by tree path

The manifest is written LAST with ``status="complete"``: a checkpoint
torn by a crash mid-write has no manifest, and ``latest_step`` skips it.

Keys are the reference's tree paths (``jax.tree_util.keystr``): a dict
key is ``['name']``, a NamedTuple field (``OptState``) ``.name`` and a
list or tuple entry ``[i]``, so a train state spells
``"['opt'].step"``, ``"['opt'].m['a']['w']"``, ``"['params']['a']['w']"``,
and a checkpoint written by either package restores in the other.

The tree half: ``save_async`` copies every tensor to the host
(``.detach().cpu().numpy()``) before its writer thread starts and returns
a ``SaveHandle`` whose ``result()`` re-raises whatever the thread hit;
``CheckpointManager`` saves every ``interval`` steps, keeps the last
``keep`` (its collection runs in the writer thread, after the new step
exists) and surfaces a failed background write on the next
``maybe_save`` or ``wait``.  ``restore`` puts each leaf on the device of
the matching ``tree_like`` leaf, or, with ``shardings=`` (a tree of
``distributed.sharding.NamedSharding``), cuts it onto that mesh's
shards: a checkpoint written on one mesh restores onto any other, the
reference's elastic re-mesh.  ``save`` and ``save_async`` take sharded
trees too and gather each ``ShardedTensor`` leaf once, so a sharded
state's file equals an unsharded one's key for key.  bf16 leaves are
refused: numpy has no bf16 type without ``ml_dtypes``, and every
config's ``param_dtype`` is f32, so no train state holds one.

The session half: ``save_sessions`` / ``load_sessions`` keep the
scalars (stream position, code name, consumed stages) in the manifest's
``extra`` and the arrays under ``"['<sid>']['lam']"`` and
``"['<sid>']['hist']"``; arrays are numpy there, the engine moving its
tensors to and from its device.
"""
from __future__ import annotations

import json
import pathlib
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "save",
    "save_async",
    "SaveHandle",
    "restore",
    "latest_step",
    "CheckpointManager",
    "save_sessions",
    "load_sessions",
]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key suffix, child) pairs of a tree node in the reference's order,
    or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """A tree of dicts, NamedTuples, lists and tuples -> {key path: leaf},
    keys spelled and ordered as the reference's tree paths."""
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for suffix, child in kids:
        flat.update(_flatten(child, prefix + suffix))
    return flat


def _rebuild(tree, fn, prefix: str = ""):
    """The structure of ``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, f"{prefix}[{k!r}]") for k in tree}
    vals = [_rebuild(c, fn, prefix + suffix) for suffix, c in kids]
    return type(tree)(*vals) if _is_namedtuple(tree) else type(tree)(vals)


def _to_host(leaf) -> np.ndarray:
    from repro_torch.distributed.sharding import ShardedTensor, gather

    if isinstance(leaf, ShardedTensor):
        leaf = gather(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "a bf16 tensor cannot be checkpointed: numpy has no bf16 type "
                "without ml_dtypes; keep the train state in f32 (every "
                "config's param_dtype)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host_tree(tree):
    return _rebuild(tree, lambda _, leaf: _to_host(leaf))


def save(ckpt_dir, step: int, tree, extra: Optional[dict] = None) -> pathlib.Path:
    """Write ``tree`` (tensors go to the host first) as checkpoint
    ``step``: the arrays first, the manifest last."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:09d}"
    out.mkdir(parents=True, exist_ok=True)
    flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
    np.savez(out / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
        "time": time.time(),
        "status": "complete",  # written last: torn writes lack this file
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return out


class SaveHandle:
    """Handle on an async checkpoint write: ``result()`` joins and returns
    the written path or re-raises what the writer thread raised;
    ``join()`` does the same for thread-style callers."""

    def __init__(self, fn, args):
        self._box: dict = {}
        self._thread = threading.Thread(
            target=self._run, args=(fn, args), daemon=True
        )
        self._thread.start()

    def _run(self, fn, args):
        try:
            self._box["result"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — captured, re-raised by result()
            self._box["error"] = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def exception(self, timeout: Optional[float] = None):
        self._thread.join(timeout)
        return self._box.get("error")

    def result(self, timeout: Optional[float] = None):
        self._thread.join(timeout)
        if "error" in self._box:
            raise self._box["error"]
        return self._box.get("result")

    def join(self, timeout: Optional[float] = None):
        self.result(timeout)


def save_async(ckpt_dir, step: int, tree, extra=None) -> SaveHandle:
    """Device -> host copy now; the disk write on a background thread.
    Call ``.result()`` on the handle to join and observe a failure."""
    host_tree = _host_tree(tree)  # blocks on the copies only
    return SaveHandle(save, (ckpt_dir, step, host_tree, extra))


def latest_step(ckpt_dir) -> Optional[int]:
    """The newest step whose manifest says ``complete``, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for d in ckpt_dir.glob("step_*"):
        m = d / "manifest.json"
        if m.exists():
            try:
                if json.loads(m.read_text()).get("status") == "complete":
                    steps.append(int(d.name.split("_")[1]))
            except (ValueError, json.JSONDecodeError):
                continue
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, tree_like, shardings=None):
    """Checkpoint ``step`` in the structure of ``tree_like``: a tensor leaf
    comes back as a tensor on that leaf's device (with the checkpoint's
    dtype), a ``ShardedTensor`` leaf in that leaf's layout, any other leaf
    as a numpy array.  ``shardings``, a tree of ``NamedSharding`` in
    ``tree_like``'s structure, cuts every leaf onto its mesh instead
    (``distributed.sharding.shard``)."""
    from repro_torch.distributed.sharding import ShardedTensor, shard

    out = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    dtypes = json.loads((out / "manifest.json").read_text())["dtypes"]
    layouts = _flatten(shardings) if shardings is not None else {}

    def load(key, like):
        if dtypes.get(key) == "bfloat16":
            raise TypeError(
                f"checkpoint leaf {key} is bf16, which numpy cannot read "
                "without ml_dtypes; the port refuses it")
        arr = data[key]
        if key in layouts:
            return shard(torch.from_numpy(arr), layouts[key].mesh, layouts[key].spec)
        if isinstance(like, ShardedTensor):
            return shard(torch.from_numpy(arr), like.mesh, like.spec)
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(arr).to(like.device)
        return arr

    with np.load(out / "arrays.npz") as data:
        return _rebuild(tree_like, load)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints, saves every ``interval`` steps.

    A failed background write surfaces on the NEXT ``maybe_save`` or on
    ``wait()``: the loop driving the manager sees the error at its next
    checkpoint boundary, not as a hole in the history at restore time."""

    def __init__(self, ckpt_dir, interval: int = 100, keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.interval = interval
        self.keep = keep
        self._pending: Optional[SaveHandle] = None

    def maybe_save(self, step: int, tree, extra=None) -> bool:
        if step % self.interval:
            return False
        if self._pending is not None:
            self._pending.result()  # one in flight; surfaces prior errors
        host_tree = _host_tree(tree)  # blocks on the copies only

        def write():
            out = save(self.dir, step, host_tree, extra)
            self._gc()  # in the thread: runs after the new step exists
            return out

        self._pending = SaveHandle(write, ())
        return True

    def wait(self):
        if self._pending is not None:
            handle, self._pending = self._pending, None
            handle.result()

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.dir.glob("step_*")
        )
        for s in steps[: -self.keep]:
            d = self.dir / f"step_{s:09d}"
            for f in d.iterdir():
                f.unlink()
            d.rmdir()


def save_sessions(
    ckpt_dir, step: int, sessions: Dict[str, dict],
    extra: Optional[dict] = None,
) -> pathlib.Path:
    """Write the engine's session table as checkpoint ``step``.  A record
    is {"lam": (F, S) metrics, "hist": survivor ring, "pos": stream
    position in radix steps, "code": registry name, "consumed": consumed
    stages}, its arrays on the host."""
    tree = {
        sid: {"lam": np.asarray(s["lam"]), "hist": np.asarray(s["hist"])}
        for sid, s in sessions.items()
    }
    meta = {
        sid: {
            "pos": int(s["pos"]),
            "code": str(s["code"]),
            "consumed": int(s.get("consumed", 0)),
        }
        for sid, s in sessions.items()
    }
    return save(ckpt_dir, step, tree,
                extra={"sessions": meta, **(extra or {})})


def load_sessions(
    ckpt_dir, step: Optional[int] = None,
) -> Tuple[Optional[int], Dict[str, dict], dict]:
    """Load the latest COMPLETE session checkpoint (or ``step``).

    Returns ``(step, sessions, extra)`` with sessions in ``save_sessions``
    record form (numpy arrays); ``(None, {}, {})`` when no complete
    checkpoint exists."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, {}, {}
    out = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((out / "manifest.json").read_text())
    data = np.load(out / "arrays.npz")
    extra = dict(manifest.get("extra", {}))
    meta = extra.pop("sessions", {})
    sessions = {}
    for sid, m in meta.items():
        sessions[sid] = {
            "lam": data[f"['{sid}']['lam']"],
            "hist": data[f"['{sid}']['hist']"],
            "pos": int(m["pos"]),
            "code": str(m["code"]),
            "consumed": int(m["consumed"]),
        }
    return step, sessions, extra
