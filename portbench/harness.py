"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  code, its registry name in the program, the tiling and precision;
- ``traffic/<traffic>.json``: the entry (``entries/<entry>.py``), the
  loop (``loops/<loop>.py``, default ``closed``), the batch shape, the
  channel, the pool, the samples and the calls in flight;
- ``cells/<cell>.json``: the limit of each number the entry compares;
- ``metrics/<name up to its first dot>.py``: a reader, ``read(ctx)``,
  of one metric, which returns None where it finds nothing to read.

The run: draw ``pool`` batches from the seed on the device (the entry's
own ``draw`` where it has one, else ``generate.draw``), build the
program's entry, call it as many times as the window has calls in
flight, and freeze the set-up's objects out of the garbage collector's
full passes (set-up ends there); then the traffic's loop calls it for
``seconds``, profiling a stretch of calls with ``trace``.  Outputs are
sampled by a reservoir drawn from the seed and judged by the entry's
plain reference once the window has closed, the peak memory read and the
program freed.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import torch

from portbench import codes, generate
from portbench.loops import sync
from portbench.trace import TraceSummary
from portbench.work import Work

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent

__all__ = ["Cell", "RunContext", "load_benchmark", "resolve", "run_cell", "ROOT"]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    entry: object
    loop: object
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class RunContext:
    """What a metric's reader reads."""
    calls: int
    window_s: float
    info_bits: int
    latencies_s: List[float]
    setup_s: float
    work: Work  # the least work of one call
    trace: Optional[TraceSummary]
    extra: dict = dataclasses.field(default_factory=dict)  # what the loop measured besides


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(PACKAGE / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(PACKAGE / "cells" / f"{workload}.json")["limits"]
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    loop = importlib.import_module(f"portbench.loops.{traffic.get('loop', 'closed')}")
    if set(entry.CHECKS) != set(limits):
        raise SystemExit(f"{workload}: limits {sorted(limits)} do not match the "
                         f"entry's checks {sorted(entry.CHECKS)}")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=limits, entry=entry, loop=loop,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def reader(name: str) -> Callable:
    return importlib.import_module(f"portbench.metrics.{name.split('.')[0]}").read


def _card_notes(device: torch.device) -> dict:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    if device.type != "cuda":
        return {}
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=20,
        ).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"not read: {e!r}"
    return {"nvidia_smi": {"query": query, "value": out}}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, program: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object plus ``info`` (printed on
    an earlier line).  ``program(cell, batches, device)``, where given,
    makes the step in place of the entry's program (the tests put a
    broken program there, the tests and ``readings`` the control)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, cell.traffic
    mismatch = codes.registry_mismatch(config)
    if mismatch:
        raise SystemExit(f"{cell.name}: the configuration's code is not the program's "
                         f"registry entry {config['registry']!r}: {mismatch}")
    draw = getattr(cell.entry, "draw", generate.draw)
    batches = {i: draw(config, traffic, seed, i, device) for i in range(int(traffic["pool"]))}
    step = (program(cell, batches, device) if program is not None
            else cell.entry.build(config, traffic, device))
    # the first call builds or loads the kernels; as many calls held at
    # once as the window has in flight
    held = [step(batches[i % len(batches)].llrs)
            for i in range(max(1, int(traffic["in_flight"])))]
    sync(device)
    del held
    # the set-up's long-lived objects (torch, the program, the pool) out of
    # the collector's full passes, so that a full pass over them does not
    # land in a call of the window; the calls' own garbage is collected
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_process
    info_bits = cell.entry.info_bits(config, traffic, batches[0])
    w, samples = cell.loop.run(step, batches, traffic, seconds, seed, trace, device, info_bits)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del step
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.entry.judge(config, traffic, batches, samples)
    # a check that could not be computed (an output of the wrong shape, a
    # NaN) reads "inf": the result line stays strict JSON
    checks = {name: {"value": numbers[name] if math.isfinite(numbers[name]) else "inf",
                     "limit": cell.limits[name]} for name in cell.entry.CHECKS}
    ctx = RunContext(
        calls=w.calls, window_s=w.window_s, info_bits=w.ok_calls_bits,
        latencies_s=w.latencies_s, setup_s=setup_s,
        work=cell.entry.work(config, traffic, batches[0]), trace=w.trace, extra=w.extra,
    )
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (w.attempted > 0 and w.failed == 0 and len(samples) > 0
               and all(numbers[name] <= cell.limits[name] for name in cell.entry.CHECKS))
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": w.attempted, "failed": w.failed,
              "metrics": metrics, "device": dev_info}
    if trace and w.trace is not None:
        dev_info["busy_s"] = w.trace.busy_s
        dev_info["window_s"] = w.trace.window_s
        result["breakdown"] = {"device_ops": w.trace.device_ops, "idle_gaps": w.trace.idle_gaps}
    result["checks"] = checks
    work = ctx.work
    info = {
        "workload": cell.name, "seed": seed, "seconds": seconds, "trace": trace,
        "calls": w.calls, "window_s": w.window_s, "setup_s": setup_s,
        "latency_ms": _latency_summary(w.latencies_s),
        "samples": [i for i, _ in samples], "errors": w.errors,
        "least_time_ms_a_call": work.least_time_s() * 1e3, "bound_by": work.bound_by(),
        "trace_summary": dataclasses.asdict(w.trace) if w.trace is not None else None,
        **_card_notes(device),
    }
    return {"result": result, "info": info}


def _latency_summary(latencies_s: list) -> Optional[dict]:
    """The calls' latency quartiles and extremes, for the details line."""
    if len(latencies_s) < 2:
        return None
    q = statistics.quantiles(latencies_s, n=4)
    return {"min": min(latencies_s) * 1e3, "q1": q[0] * 1e3, "median": q[1] * 1e3,
            "q3": q[2] * 1e3, "max": max(latencies_s) * 1e3, "calls": len(latencies_s)}


def print_result(run: dict) -> None:
    """The info line, then the result as the last line of stdout; the
    numbers compared, each beside its limit, as the last lines of stderr."""
    for err in run["info"]["errors"]:
        print(err, file=sys.stderr)
    print(json.dumps({"portbench": run["info"]}), flush=True)
    print(json.dumps(run["result"]), flush=True)
    for name, c in run["result"]["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
