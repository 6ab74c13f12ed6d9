"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        [--smoke] [--steps 300] [--batch 8] [--seq 256] [--ckpt-dir DIR] \
        [--microbatches 1] [--device cpu]

``--smoke`` trains the reduced config of the family; without it, the
full published config.  It runs on the card unless ``--device cpu`` is
given; there is no fallback to the CPU.  One card, as the reference's
launcher is one host's; the sharded step over a mesh of logical shards
is ``distributed/spmd.py``'s.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv=None):
    """Returns the loop's history: (step, loss) at each log step."""
    args = _parser().parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    loop = TrainLoopConfig(
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval,
        microbatches=args.microbatches,
    )
    opt = AdamWConfig(peak_lr=args.lr, total_steps=args.steps)
    _, _, history = train(cfg, loop, opt, device=args.device)
    return history


if __name__ == "__main__":
    main()
