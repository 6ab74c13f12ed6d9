"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The program under test is ``repro_torch``
from the checkout's ``src/``; nothing here imports ``jax`` or ``repro``,
and the run exits non-zero, with no result, where either is loaded once
the window has closed, where there is no CUDA card, or where the card
count is below the cell's.  Standard output ends with the result's JSON
line; the line before it holds the run's details.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    # every kernel cache at a fixed path inside the checkout (the program's
    # own nvcc builds go to build/torch_ext/, fixed in its code)
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(cache / "torch_kernels")
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"the program is missing: no {src / 'repro_torch'}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from portbench import harness

    cell = harness.resolve(harness.load_benchmark(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run: {found}", file=sys.stderr)
        return 3
    harness.print_result(run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
