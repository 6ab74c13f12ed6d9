"""Readings that set a cell's limits: the numbers compared, of the
program and of the control, over many seeds, in one process, at the
cell's own size.

    python3 -m portbench.readings --workload <name> --seeds 1,2,3 --control-seeds 7,8,9 [--seconds 1]

Each seed is one run of the cell by ``harness.run_cell`` with a window
of ``--seconds`` (long enough for as many calls as the cell samples):
the program's, or the control's, which puts the entry's plain reference
in bfloat16 in the program's place.  Prints one JSON line a run: the
numbers compared, the pool indices judged and the calls.  The
benchmark's own runs never call this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.run import ROOT


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def control_program(cell, batches, device):
    """The control as ``run_cell``'s ``program``: each call answered by
    the entry's plain reference in bfloat16 on the batch it was given."""
    def step(llrs):
        batch = next(b for b in batches.values() if b.llrs is llrs)
        return cell.entry.control(cell.config, cell.traffic, batch)
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload, ROOT)
    for kind, seeds in (("program", _seeds(args.seeds)), ("control", _seeds(args.control_seeds))):
        for seed in seeds:
            t0 = time.perf_counter()
            run = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                                   program=control_program if kind == "control" else None)
            checks = run["result"]["checks"]
            print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                              "numbers": {k: c["value"] for k, c in checks.items()},
                              "judged": run["info"]["samples"], "calls": run["info"]["calls"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
