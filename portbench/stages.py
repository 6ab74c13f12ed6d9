"""Per-call readings of the program's decode stages.

``repro_torch.obs.trace.stage_totals()`` sums, for each stage of the
decode paths (``decode``, ``front_door``, ``window_gather``, ``k1``-``k3``,
``traceback``, ``scan``, ``alpha``, ``beta``, ...), its device seconds,
plain-loop steps and host synchronisations.  The stages
record only while a profiler session runs (or a recorder is installed,
which the harness never does), so in a run with ``--trace 1`` the totals
are those of the traced calls alone.  ``per_call`` divides one field,
summed over the named stages or over all of them, by the traced calls.
It returns None where there is no trace, where the program has no
``stage_totals`` (a program from before the stages) or where none of the
named stages ran.
"""
from __future__ import annotations

from typing import Optional


def totals() -> Optional[dict]:
    """The program's stage totals, or None where it keeps none."""
    from repro_torch.obs import trace

    read = getattr(trace, "stage_totals", None)
    return read() if read is not None else None


def per_call(ctx, field: str, stages=None) -> Optional[float]:
    """``field`` summed over ``stages`` (None: every stage that ran), over
    the traced calls."""
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    got = totals()
    if not got:
        return None
    names = list(got) if stages is None else [s for s in stages if s in got]
    if not names:
        return None
    return sum(got[s][field] for s in names) / ctx.trace.calls


def device_ms(ctx, *stages: str) -> Optional[float]:
    """The named stages' device time a traced call, in milliseconds: the
    distance of CUDA events at entry and exit, so the gaps in which the
    stream waits for the profiled host's launches count too."""
    value = per_call(ctx, "device_s", stages)
    return None if value is None else value * 1e3
