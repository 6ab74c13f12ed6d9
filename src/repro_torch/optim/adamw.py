"""AdamW with global-norm clipping and a warm-up + cosine schedule, the
port of the reference's ``optim/adamw.py``.

The reference's arithmetic, not ``torch.optim.AdamW``'s: the bias
corrections are ``b ** step`` in f32 with ``step`` an int32 tensor that
the update advances (no Python step count), ``eps`` is added to
``sqrt(vhat)``, the decay is folded into the same ``lr`` product, and the
gradients are clipped by their global norm first.  The update is
functional, as the reference's: it returns new parameter and moment
trees and writes none of its inputs (the train loop drops the old ones,
which is what the reference's ``donate_argnums`` does).

Trees are nested dicts of tensors; leaves are visited in sorted-key
order at every level, the reference's ``jax.tree`` order, so the
global norm sums its leaves in the same order.

Precision: fed the same numpy gradients, ``adamw_update`` holds the
reference's new parameters and moments within 1e-6 (f32 throughout; the
two frameworks' ``cos``, ``sqrt`` and reductions may round differently
in the last ulp).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "tree_leaves", "tree_map"]


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def cosine_schedule(cfg: AdamWConfig) -> Callable:
    """step (an int tensor) -> learning rate (an f32 0-d tensor): linear
    warm-up to ``peak_lr``, then a cosine down to ``min_lr_ratio *
    peak_lr`` at ``total_steps``."""
    def lr(step):
        step = step.to(torch.float32)
        warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
        t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        floor = cfg.min_lr_ratio * cfg.peak_lr
        cos = floor + 0.5 * (cfg.peak_lr - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(step < cfg.warmup_steps, warm, cos)

    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in the tree's order."""
    total = 0
    for g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def adamw_init(params) -> OptState:
    """Step 0 and f32 zero moments shaped as ``params``, on their devices."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


@torch.no_grad()
def adamw_update(grads, state: OptState, params, cfg: AdamWConfig,
                 lr_fn: Optional[Callable] = None):
    """Returns (new_params, new_state, stats), stats being the step's
    ``lr``, ``grad_norm`` and ``clip_scale`` as 0-d tensors."""
    lr_fn = lr_fn or cosine_schedule(cfg)
    step = state.step + 1
    lr = lr_fn(step)

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.to(torch.float32)
        newp = pf - lr * (delta + cfg.weight_decay * pf)
        return newp.to(p.dtype), m, v

    out = tree_map(upd, grads, state.m, state.v, params)
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], out) for i in range(3))
    stats = {"lr": lr, "grad_norm": gnorm, "clip_scale": scale}
    return new_p, OptState(step=step, m=new_m, v=new_v), stats
