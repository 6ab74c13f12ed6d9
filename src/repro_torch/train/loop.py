"""Training loop: steps, logging, checkpoints and resume, the port of the
reference's ``train/loop.py``.

``train`` draws the initial weights from a CPU generator seeded with
``loop.seed`` (so the CPU and the card start from the same parameters),
resumes from the newest complete checkpoint under ``loop.ckpt_dir`` (the
checkpoint of step ``s`` holds the state after step ``s``, so the run
goes on at ``s + 1``), feeds ``TokenStream`` batches to
``make_train_step`` and saves through ``CheckpointManager`` after every
step ``s`` with ``s % ckpt_interval == 0``.  The loss is read on the
host only at log steps; the step time given to ``StragglerMonitor`` is
the host's, as the reference's is under asynchronous dispatch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.backend import resolve_device
from repro_torch.data.pipeline import TokenStream
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.runtime.failure import StragglerMonitor
from repro_torch.train.step import init_train_state, make_train_step

__all__ = ["TrainLoopConfig", "train"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 200
    batch: int = 8
    seq_len: int = 256
    ckpt_dir: Optional[str] = None
    ckpt_interval: int = 50
    log_interval: int = 10
    seed: int = 0
    microbatches: int = 1


def train(
    cfg: ArchConfig,
    loop: TrainLoopConfig,
    opt_cfg: Optional[AdamWConfig] = None,
    log_fn: Callable = print,
    device=None,
):
    """Train on the synthetic stream on ``device`` (None: the card);
    resumes from the latest checkpoint.  Returns (params, opt_state,
    history), history being the (step, loss) pairs of the log steps."""
    dev = resolve_device(device)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=loop.steps)
    gen = torch.Generator().manual_seed(loop.seed)
    params, opt_state = init_train_state(cfg, gen, dev)
    start = 0

    mgr = None
    if loop.ckpt_dir:
        mgr = CheckpointManager(loop.ckpt_dir, interval=loop.ckpt_interval)
        last = latest_step(loop.ckpt_dir)
        if last is not None:
            state = restore(loop.ckpt_dir, last, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start = last + 1  # the checkpoint holds the state after step `last`
            log_fn(f"[train] resumed from checkpoint step {last}")

    stream = TokenStream(
        vocab_size=cfg.vocab_size,
        batch=loop.batch,
        seq_len=loop.seq_len,
        seed=loop.seed,
        prefix_len=cfg.prefix_len,
        d_model=cfg.d_model,
        device=dev,
    )
    step_fn = make_train_step(cfg, opt_cfg, microbatches=loop.microbatches)
    straggler = StragglerMonitor()
    history = []
    for step in range(start, loop.steps):
        t0 = time.time()
        batch = stream.batch_at(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % loop.log_interval == 0 or step == loop.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            history.append((step, loss))
            log_fn(
                f"[train] step {step:>5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.2f} ({dt:.2f}s)"
            )
        straggler.record_step({0: time.time() - t0})
        if mgr is not None:
            mgr.maybe_save(step, {"params": params, "opt": opt_state})
    if mgr is not None:
        mgr.wait()
    return params, opt_state, history
