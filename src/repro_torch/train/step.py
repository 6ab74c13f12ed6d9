"""Train-step factory: loss, gradients, AdamW update, the port of the
reference's ``train/step.py``.

The reference takes ``jax.value_and_grad`` of ``lm_loss`` over the
parameter pytree; here the gradients are ``torch.autograd.grad`` of the
same loss with respect to the leaves of the functional parameter tree
(each leaf a detached view that requires grad, so no weight is copied).
``make_train_step(cfg)(params, opt_state, batch)`` returns new trees and
writes none of its inputs, as the reference's jitted step does.

Precision contract (held by ``tests/test_torch_train.py``; the card is
held to the CPU run at the same tolerances by ``chip_smoke.py``):
  * at f32 activations the loss holds the reference's within rtol 1e-5
    and every gradient leaf within rtol 1e-4 of that leaf's largest
    magnitude;
  * the first moments likewise, the second within 2e-4 of their leaf's
    largest, and the new parameters after one step within 1e-3 x lr
    (+ 1e-6 x |p|) wherever the gradient is at least 1e-3 of its leaf's
    largest, and within 2 x lr elsewhere.  AdamW normalises each entry
    by ``sqrt(vhat) + eps``: at step 1 the update is ``lr * g / (|g| +
    eps)``, about ``lr * sign(g)``, so a rounding difference in a
    near-zero gradient can move its entry by up to a whole step (2 x lr
    when the sign flips) in either package;
  * at bf16 activations (the configs' default) the loss holds within
    2e-2 and the gradients are checked to be finite; the MoE archs are
    held at f32 only, since one bf16 ulp can flip a top-2 routing choice;
  * no TF32 anywhere.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import lm
from repro_torch.optim.adamw import (
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    tree_leaves,
    tree_map,
)

__all__ = ["lm_loss", "make_train_step", "init_train_state",
           "opt_state_from_numpy"]


def lm_loss(params, cfg: ArchConfig, batch):
    """Next-token cross-entropy (+ 0.01 x the MoE aux loss); labels < 0
    are masked.  Returns (loss, {"ce_loss", "aux_loss"}).

    The reference reduces a (B, S, V) f32 one-hot against the logits so
    that GSPMD keeps the vocab axis sharded (src/repro/train/step.py:
    37-42).  On one device ``torch.gather`` of ``max(labels, 0)`` gives
    the same true-class logit bit for bit on finite logits (one exact
    product and exact zeros) and the same one-hot gradient, without the
    (B, S, V) one-hot."""
    logits, aux = lm.forward(
        params, cfg, batch["tokens"], batch.get("prefix_embeds"), mode="train"
    )
    logits = logits[:, cfg.prefix_len:].to(torch.float32)
    # the reference constrains the logits' batch and vocab axes here
    # (src/repro/train/step.py:35): sharding slice
    labels = batch["labels"]
    lse = torch.logsumexp(logits, dim=-1)  # (B, S)
    # the one-hot's vocab-axis constraint (src/repro/train/step.py:41)
    # has no one-hot to act on here: sharding slice
    true_logit = torch.gather(
        logits, -1, torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - true_logit
    mask = (labels >= 0).to(torch.float32)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    return loss + 0.01 * aux, metrics


def init_train_state(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                     device=None):
    """(params, opt_state) on ``device`` (None: the card); the weights are
    ``lm.init_params``'s draws from ``generator``."""
    params = lm.init_params(cfg, generator, device)
    return params, adamw_init(params)


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def _grad_fn(cfg: ArchConfig):
    """params, batch -> (loss, metrics, grads), all detached."""
    def grad_fn(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, metrics = lm_loss(leaves, cfg, batch)
            grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
        it = iter(grads)
        # a leaf the loss does not reach gets zeros, as jax.grad gives
        grads = tree_map(lambda p: _or_zeros(next(it), p), leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    return grad_fn


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).

    ``microbatches > 1`` accumulates gradients over equal slices of the
    batch's leading axis: the f32 gradients are summed in slice order and
    divided by the count, the loss likewise; the metrics are the last
    slice's (the reference's ``lax.scan`` and ``m[-1]``).  Activation
    memory then scales with the slice."""
    opt_cfg = opt_cfg or AdamWConfig()
    lr_fn = cosine_schedule(opt_cfg)
    grad_fn = _grad_fn(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(
                    f"batch of {n} does not split into {microbatches} microbatches")
            size = n // microbatches
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                params)
            loss = 0.0
            for i in range(microbatches):
                part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                loss_i, metrics, g = grad_fn(params, part)
                grads = tree_map(torch.add, grads, g)
                loss = loss + loss_i
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        params, opt_state, stats = adamw_update(grads, opt_state, params,
                                                opt_cfg, lr_fn)
        return params, opt_state, {**metrics, **stats, "loss": loss}

    return train_step


def opt_state_from_numpy(state, device=None) -> OptState:
    """The reference's ``OptState`` as numpy (``step``, then the ``m`` and
    ``v`` trees as nested dicts of numpy arrays) as the port's tensors on
    ``device`` (None: the card)."""
    step, m, v = state
    dev = resolve_device(device)
    return OptState(
        step=torch.as_tensor(np.array(step), dtype=torch.int32, device=dev),
        m=lm.params_from_numpy(m, dev),
        v=lm.params_from_numpy(v, dev),
    )
