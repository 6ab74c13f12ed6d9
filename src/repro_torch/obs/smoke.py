"""Observability smoke gate: ``python -m repro_torch.obs.smoke``, a port
of the reference's ``obs/smoke.py``.

Drives the deterministic mixed-SLO engine workload of
``repro_torch.obs.top.demo_workload`` twice through ONE engine (on the
card unless ``--device cpu``): first with tracing disabled (the
``NullRecorder`` default), then with a live ``SpanRecorder`` and JSONL
sink, and asserts:

  1. **bit-identity** — every completed ticket's bits are identical
     with observability off and on (instrumentation sits at dispatch
     boundaries, never inside a decode).
  2. **Prometheus output parses** — ``registry.render_prometheus()``
     passes the validating text-format parser below (TYPE-declared
     families, well-formed samples, cumulative histogram buckets,
     ``_count`` == the +Inf bucket).
  3. **spans nest correctly** — every ``engine.batch`` span contains
     assemble/jit_lookup/dispatch/emit children, ``device_wait`` nests
     under dispatch, child time bounds sit inside the parent, and the
     JSONL sink replays the same records.
  4. **overhead** — the median instrumented wall time over ``--reps``
     runs is within ``--max-overhead`` (5%) of the disabled wall time,
     plus 10 ms so that short runs do not gate on timer noise.  Both
     modes replay the identical request trace through the same engine,
     so the difference is the instrumentation.  The reference times all
     disabled runs, then all instrumented ones; here they alternate.
  5. **profile attributes** — every ``engine.dispatch`` span carries
     the modelled device-profile attributes (``obs/profile.py``,
     ``hbm_bytes_modeled`` and the rest), as the reference asserts.

Exits non-zero on any violation.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import JsonlSink, NullRecorder, SpanRecorder
from repro_torch.obs.top import demo_workload

__all__ = ["parse_prometheus", "main"]

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_SAMPLE_RE = re.compile(
    rf"^({_NAME})(\{{.*\}})? (-?(?:[0-9.]+(?:[eE][+-]?[0-9]+)?|Inf)|NaN|\+Inf)$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)",?')


def _parse_labels(body: str) -> Dict[str, str]:
    inner = body[1:-1]
    labels: Dict[str, str] = {}
    pos = 0
    while pos < len(inner):
        m = _LABEL_RE.match(inner, pos)
        if m is None:
            raise ValueError(f"malformed label body {body!r} at {pos}")
        raw = m.group(2)  # undo the exposition-format escaping
        labels[m.group(1)] = re.sub(
            r"\\(.)", lambda e: {"n": "\n"}.get(e.group(1), e.group(1)), raw
        )
        pos = m.end()
    return labels


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Validating parser of the Prometheus text exposition format
    (version 0.0.4) as ``render_prometheus`` emits it.  Returns
    {family: {"type": ..., "samples": [(name, labels, value), ...]}};
    raises ``ValueError`` on any malformed line or histogram."""
    fams: Dict[str, dict] = {}
    declared: Optional[str] = None
    for ln, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) != 4 or parts[3] not in (
                "counter", "gauge", "histogram", "untyped"
            ):
                raise ValueError(f"line {ln}: bad TYPE line {line!r}")
            declared = parts[2]
            fams[declared] = {"type": parts[3], "samples": []}
            continue
        if line.startswith("#"):
            raise ValueError(f"line {ln}: unknown comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name, lbl_body, value = m.groups()
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in fams:
                base = name[: -len(suffix)]
        if base not in fams:
            raise ValueError(f"line {ln}: sample {name!r} has no TYPE")
        if fams[base]["type"] == "histogram" and base == name:
            raise ValueError(
                f"line {ln}: bare histogram sample {name!r}"
            )
        labels = _parse_labels(lbl_body) if lbl_body else {}
        fams[base]["samples"].append((name, labels, float(value)))
    for fam, rec in fams.items():
        if rec["type"] != "histogram":
            continue
        series: Dict[Tuple, List[Tuple[float, float]]] = {}
        counts: Dict[Tuple, float] = {}
        for name, labels, value in rec["samples"]:
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            if name == f"{fam}_bucket":
                le = labels.get("le")
                if le is None:
                    raise ValueError(f"{fam}: bucket sample without le")
                series.setdefault(key, []).append(
                    (math.inf if le == "+Inf" else float(le), value)
                )
            elif name == f"{fam}_count":
                counts[key] = value
        for key, buckets in series.items():
            buckets.sort()
            if buckets[-1][0] != math.inf:
                raise ValueError(f"{fam}{dict(key)}: missing +Inf bucket")
            acc = [v for _, v in buckets]
            if any(b > a for a, b in zip(acc[1:], acc)):
                raise ValueError(
                    f"{fam}{dict(key)}: non-cumulative buckets"
                )
            if key in counts and counts[key] != acc[-1]:
                raise ValueError(
                    f"{fam}{dict(key)}: _count {counts[key]} != "
                    f"+Inf bucket {acc[-1]}"
                )
    return fams


def _sync(engine) -> None:
    """Wait for the engine's device (its tickets are already on the host;
    this only closes the timing window on the card)."""
    import torch

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _ticket_bits(done) -> List[np.ndarray]:
    return [t.bits for t in done if t.bits is not None]


def _check_spans(rec: SpanRecorder) -> int:
    batches = rec.find("engine.batch")
    assert batches, "no engine.batch spans recorded"
    assert rec.open_spans == 0, f"{rec.open_spans} spans left open"
    for b in batches:
        kids = {c.name for c in rec.children(b)}
        need = {
            "engine.assemble", "engine.jit_lookup",
            "engine.dispatch", "engine.emit",
        }
        assert need <= kids, f"batch span missing children: {need - kids}"
        for c in rec.children(b):
            assert c.t0 >= b.t0 and c.t1 <= b.t1, (
                f"child {c.name} [{c.t0}, {c.t1}] escapes parent "
                f"[{b.t0}, {b.t1}]"
            )
        (disp,) = [c for c in rec.children(b) if c.name == "engine.dispatch"]
        waits = [c.name for c in rec.children(disp)]
        assert "engine.device_wait" in waits, (
            f"device_wait not nested under dispatch (children: {waits})"
        )
        assert "hbm_bytes_modeled" in disp.attrs, (
            "dispatch span missing device-profile attributes"
        )
    return len(batches)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.smoke",
        description="observability smoke gate",
    )
    ap.add_argument(
        "--reps", type=int, default=3,
        help="timed repetitions per mode (median taken)",
    )
    ap.add_argument(
        "--max-overhead", type=float, default=0.05,
        help="relative instrumented-vs-disabled overhead bound",
    )
    ap.add_argument(
        "--device", default=None,
        help="the engine's device: cpu, or the card (default)",
    )
    args = ap.parse_args(argv)

    # warm-up and reference run, tracing disabled (builds the kernels and
    # fills the engine's callable cache)
    engine, done_off = demo_workload(device=args.device)
    bits_off = _ticket_bits(done_off)
    assert bits_off, "workload produced no completed tickets"

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "smoke.jsonl")
        rec = SpanRecorder(sink=JsonlSink(path))
        engine.recorder = rec
        _, done_on = demo_workload(engine=engine)
        rec.close()

        # 1. bit-identity with observability on vs off
        bits_on = _ticket_bits(done_on)
        assert len(bits_on) == len(bits_off), (
            f"{len(bits_on)} tickets traced vs {len(bits_off)} untraced"
        )
        for a, b in zip(bits_off, bits_on):
            np.testing.assert_array_equal(a, b)
        print(f"bit-identity    OK ({len(bits_on)} tickets)")

        # 2. Prometheus text output parses
        fams = parse_prometheus(engine.registry.render_prometheus())
        for fam in (
            "engine_requests_total", "engine_batches_total",
            "engine_sojourn_seconds",
        ):
            assert fam in fams and fams[fam]["samples"], f"missing {fam}"
        print(f"prometheus      OK ({len(fams)} families)")

        # 3. spans nest correctly, and the JSONL sink replays them
        n_batches = _check_spans(rec)
        with open(path) as f:
            lines = [json.loads(x) for x in f if x.strip()]
        kinds = {x["type"] for x in lines}
        assert kinds <= {"span", "event", "metrics"}, kinds
        assert sum(
            1 for x in lines
            if x["type"] == "span" and x["name"] == "engine.batch"
        ) == n_batches, "JSONL sink lost batch spans"
        print(f"span nesting    OK ({n_batches} batch spans)")

    # 4. overhead gate: identical replays through the same engine
    def timed(recorder) -> float:
        engine.recorder = recorder
        t0 = time.perf_counter()
        demo_workload(engine=engine)
        _sync(engine)
        return time.perf_counter() - t0

    # off and on runs alternate, so that a change of the host's load
    # between the two halves does not land on one mode
    off, on = [], []
    for _ in range(args.reps):
        off.append(timed(NullRecorder()))
        on.append(timed(SpanRecorder()))
    engine.recorder = NullRecorder()
    med_off, med_on = statistics.median(off), statistics.median(on)
    bound = med_off * (1.0 + args.max_overhead) + 0.010
    print(
        f"overhead        {'OK' if med_on <= bound else 'FAIL'} "
        f"(off={med_off * 1e3:.1f}ms on={med_on * 1e3:.1f}ms "
        f"bound={bound * 1e3:.1f}ms)"
    )
    assert med_on <= bound, (
        f"instrumented median {med_on:.4f}s exceeds "
        f"{args.max_overhead:.0%}+10ms bound over disabled {med_off:.4f}s"
    )
    print("obs-smoke OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
