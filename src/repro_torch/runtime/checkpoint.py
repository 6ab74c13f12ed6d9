"""Checkpoints of the serving engine's session table: the session half of
the reference's ``runtime/checkpoint.py``, in the same on-disk format.

Layout::

    <dir>/step_000000123/
        manifest.json        # step, keys, shapes/dtypes, extra, status
        arrays.npz           # flat arrays keyed by tree path

The manifest is written LAST with ``status="complete"``: a checkpoint
torn by a crash mid-write has no manifest, and ``latest_step`` skips it.

The npz keys are the reference's tree paths, ``"['<sid>']['lam']"`` and
``"['<sid>']['hist']"``, and the scalars (stream position, code name,
consumed stages) ride the manifest's ``extra``, so a session checkpoint
written by either package loads in the other.  Arrays are numpy here:
the engine copies its device tensors to the host before ``save`` and
back to its device after ``load_sessions``.

The tree half (``save_async``, ``restore``, ``CheckpointManager``)
belongs to the LM testbed and is not ported yet.
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "save",
    "latest_step",
    "save_sessions",
    "load_sessions",
]


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts of arrays -> {key path: array}, keys in sorted order
    at every level and spelled as the reference's tree paths
    (``"['a']['b']"``)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat = {}
    for key in sorted(tree):
        flat.update(_flatten(tree[key], f"{prefix}[{key!r}]"))
    return flat


def save(ckpt_dir, step: int, tree, extra: Optional[dict] = None) -> pathlib.Path:
    """Write the nested dict of arrays ``tree`` as checkpoint ``step``:
    the arrays first, the manifest last."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = ckpt_dir / f"step_{step:09d}"
    out.mkdir(parents=True, exist_ok=True)
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
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
