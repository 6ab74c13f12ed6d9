"""Terminal metrics snapshot: ``python -m repro_torch.obs.top``, a
port of the reference's ``obs/top.py``.

Renders one engine-shaped metrics snapshot as a fixed-width terminal
report — per-cell occupancy, padding waste, sojourn p50/p99 per SLO
class, jit-cache hit rate, decode-path mix.  Input is either:

  * ``--jsonl PATH`` — the JSONL event log (``launch/serve.py
    --metrics-jsonl``, ``Observability(jsonl=...)``): the LAST
    ``{"type": "metrics"}`` line is rendered.
  * ``--demo`` — drive a small synthetic mixed-SLO workload through a
    ``DecodeEngine`` in-process, on the card unless ``--device cpu``,
    and render its registry (no files; also the workload
    ``repro_torch.obs.smoke`` replays).

The same snapshot renders to the same text as the reference's.

Quantiles here come from the power-of-two bucket counts (the snapshot
is the wire format — exact windows don't serialize), so they are
bucket-upper-edge conservative; live ``engine.stats()`` keeps the exact
window quantiles.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["render_snapshot", "demo_workload", "main"]


def _hist_quantile(bounds: List[float], counts: List[int], q: float) -> float:
    """Bucket-edge quantile over one serialized histogram series
    (counts has len(bounds)+1 entries, last = +Inf bucket)."""
    total = sum(counts)
    if not total:
        return 0.0
    target = q * total
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target and c:
            return bounds[i] if i < len(bounds) else bounds[-1]
    return bounds[-1]


def _series(snap: dict, name: str) -> List[dict]:
    fam = snap.get(name)
    return fam["series"] if fam else []


def _total(snap: dict, name: str, **flt) -> float:
    out = 0.0
    for s in _series(snap, name):
        if all(s["labels"].get(k) == str(v) for k, v in flt.items()):
            out += s.get("value", s.get("count", 0.0))
    return out


def _fmt_t(v: float) -> str:
    if v <= 0:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.2f}ms"
    return f"{v:.3f}s"


def render_snapshot(snap: dict) -> str:
    """One plain-text report from a ``MetricsRegistry.snapshot()``."""
    lines: List[str] = []
    sub = _total(snap, "engine_requests_total", event="submitted")
    comp = _total(snap, "engine_requests_total", event="completed")
    rej = _total(snap, "engine_requests_total", event="rejected")
    hits = _total(snap, "engine_jit_cache_total", event="hit")
    miss = _total(snap, "engine_jit_cache_total", event="miss")
    looks = hits + miss
    real_e = _total(snap, "engine_llr_elems_total", kind="real")
    pad_e = _total(snap, "engine_llr_elems_total", kind="pad")
    lines.append(
        f"requests  submitted={sub:.0f} completed={comp:.0f} "
        f"rejected={rej:.0f}   queue={_total(snap, 'engine_queue_depth'):.0f}"
        f"   sessions={_total(snap, 'engine_open_sessions'):.0f}"
    )
    lines.append(
        f"jit-cache hit-rate={hits / looks:.1%} ({hits:.0f}/{looks:.0f})"
        if looks else "jit-cache hit-rate=-"
    )
    lines.append(
        f"padding   waste={pad_e / (real_e + pad_e):.1%} of LLR elements"
        if real_e + pad_e else "padding   waste=-"
    )

    # the data-integrity plane (rendered only when it has seen traffic)
    inv = _total(snap, "engine_requests_total", event="invalid")
    sdc = _total(snap, "engine_requests_total", event="sdc")
    scr_f = _total(snap, "engine_scrub_total", event="frames")
    scr_fl = _total(snap, "engine_scrub_total", event="syndrome_flag")
    quar = _total(snap, "engine_quarantined_total")
    san = _total(snap, "decoder_input_sanitized_total")
    if inv or sdc or scr_f or quar or san:
        lines.append(
            f"integrity scrubbed={scr_f:.0f} flags={scr_fl:.0f} "
            f"sdc={sdc:.0f} quarantined={quar:.0f}"
            f"   invalid={inv:.0f} sanitized={san:.0f}"
        )

    # sojourn quantiles per SLO class
    soj = snap.get("engine_sojourn_seconds")
    if soj and soj["series"]:
        lines.append("")
        lines.append("sojourn (submit -> complete, bucket quantiles)")
        for s in soj["series"]:
            slo = s["labels"].get("slo", "?")
            p50 = _hist_quantile(soj["bucket_bounds"], s["buckets"], 0.50)
            p99 = _hist_quantile(soj["bucket_bounds"], s["buckets"], 0.99)
            lines.append(
                f"  {slo:<12} n={s['count']:<7} "
                f"p50={_fmt_t(p50):<9} p99={_fmt_t(p99)}"
            )

    # per-cell table from the frames counter (kind=real|pad)
    cells: Dict[Tuple[str, str, str, str], Dict[str, float]] = {}
    for s in _series(snap, "engine_frames_total"):
        lb = s["labels"]
        key = (
            lb.get("code", "?"), lb.get("path", "?"),
            lb.get("f", "?"), lb.get("t", "?"),
        )
        cells.setdefault(key, {"real": 0.0, "pad": 0.0})[
            lb.get("kind", "real")
        ] += s["value"]
    if cells:
        disp = snap.get("engine_dispatch_seconds")
        lines.append("")
        lines.append(
            f"  {'code':<14}{'path':<14}{'f':>5}{'t':>7}"
            f"{'batches':>9}{'frames':>8}{'occ':>7}"
            f"{'disp p50':>10}{'disp p99':>10}"
        )
        for key in sorted(cells):
            code, path, f, t = key
            c = cells[key]
            frames = c["real"] + c["pad"]
            occ = c["real"] / frames if frames else 0.0
            nb = _total(
                snap, "engine_batches_total", code=code, path=path, f=f, t=t
            )
            p50 = p99 = 0.0
            if disp:
                for s in disp["series"]:
                    lb = s["labels"]
                    if (lb.get("code"), lb.get("path"), lb.get("f"),
                            lb.get("t")) == key:
                        p50 = _hist_quantile(
                            disp["bucket_bounds"], s["buckets"], 0.50
                        )
                        p99 = _hist_quantile(
                            disp["bucket_bounds"], s["buckets"], 0.99
                        )
            lines.append(
                f"  {code:<14}{path:<14}{f:>5}{t:>7}{nb:>9.0f}"
                f"{c['real']:>8.0f}{occ:>7.1%}"
                f"{_fmt_t(p50):>10}{_fmt_t(p99):>10}"
            )

    paths = _series(snap, "decoder_dispatch_total")
    if paths:
        lines.append("")
        lines.append("decoder dispatches  " + "  ".join(
            f"{s['labels'].get('path', '?')}={s['value']:.0f}"
            for s in sorted(paths, key=lambda s: s["labels"].get("path", ""))
        ))
    return "\n".join(lines) + "\n"


def demo_workload(engine=None, rounds: int = 3, seed: int = 0, device=None):
    """Drive a small deterministic mixed-SLO workload through an engine
    on a virtual clock; returns (engine, list of completed tickets).
    Without ``engine`` it builds ``DecodeEngine(max_batch=8,
    min_cell=64)`` on ``device`` (None: the card).  The same workload
    ``repro_torch.obs.smoke`` replays for its gates."""
    import numpy as np

    from repro_torch.serve.engine import DecodeEngine, DecodeRequest

    if engine is None:
        engine = DecodeEngine(max_batch=8, min_cell=64, device=device)
    rng = np.random.default_rng(seed)
    beta = 2
    done = []
    now = 0.0
    for _ in range(rounds):
        for slo, n in (
            ("throughput", 96), ("latency", 60), ("throughput", 200),
            ("latency", 128), ("throughput", 96),
        ):
            for _ in range(4):
                llr = rng.normal(0.0, 1.0, (n, beta)).astype(np.float32)
                engine.submit(
                    DecodeRequest(llrs=llr, code="ccsds-k7", slo=slo),
                    now=now,
                )
                now += 1e-4
            done.extend(engine.poll(now=now))
        now += 0.1
    done.extend(engine.drain(now=now))
    return engine, done


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.top",
        description="terminal snapshot of the metrics registry",
    )
    ap.add_argument(
        "--jsonl", default=None,
        help="JSONL event log; renders the last metrics line",
    )
    ap.add_argument(
        "--demo", action="store_true",
        help="run a small synthetic engine workload and render it",
    )
    ap.add_argument(
        "--device", default=None,
        help="the demo engine's device: cpu, or the card (default)",
    )
    args = ap.parse_args(argv)
    if args.demo:
        engine, _ = demo_workload(device=args.device)
        engine.stats()  # refresh the gauges
        sys.stdout.write(render_snapshot(engine.registry.snapshot()))
        return 0
    if not args.jsonl:
        ap.error("one of --jsonl PATH or --demo is required")
    snap = None
    with open(args.jsonl) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("type") == "metrics":
                snap = rec["data"]
    if snap is None:
        sys.stderr.write(f"no metrics lines in {args.jsonl}\n")
        return 1
    sys.stdout.write(render_snapshot(snap))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
