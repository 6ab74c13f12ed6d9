"""The closed loop: each call is offered as soon as the calls in flight
allow, over the pool's batches in turn."""
from __future__ import annotations

import collections
import contextlib
import time
import traceback

import torch

from portbench.loops import Reservoir, Window, sync
from portbench.trace import CALL, WINDOW, summarize


def run(step, batches, traffic, seconds, seed, trace, device, info_bits):
    """Calls ``step`` on the pool's batches in turn for ``seconds`` (and
    until the traced stretch is done), with at most ``in_flight`` calls
    queued on the device.  With one in flight each call is due when the
    previous one is ready, and its latency runs from then to its output
    being ready on the card: on the card between two CUDA events the
    host records on the stream, the first as the call is due (the device
    idle, so it fires at once) and the second after the call's last
    launch, so that host-paced launches count and the host clock's jitter
    does not; on the CPU by the host clock.  With ``trace`` the
    ``trace_calls`` calls after the first are profiled."""
    units, in_flight = int(traffic["frames"]), int(traffic["in_flight"])
    trace_from, trace_to = 1, 1 + int(traffic["trace_calls"])
    samples = Reservoir(int(traffic["samples"]), seed)
    pending = collections.deque()
    w = Window()
    prof = window_range = traced = None
    timed = in_flight <= 1 and device.type == "cuda"
    w.t_start = due = time.perf_counter()
    while time.perf_counter() - w.t_start < seconds or (trace and w.calls < trace_to):
        if trace and w.calls == trace_from:
            sync(device)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            window_range = torch.profiler.record_function(WINDOW)
            window_range.__enter__()
        index = w.calls % len(batches)
        ctx = torch.profiler.record_function(CALL) if prof is not None else contextlib.nullcontext()
        if timed:  # the device is idle: the event marks the call's due time
            due = torch.cuda.Event(enable_timing=True)
            due.record()
        try:
            with ctx:
                out = step(batches[index].llrs)
        except Exception:  # noqa: BLE001 — counted as failed, reported on stderr
            out = None
            w.failed += units
            if len(w.errors) < 3:
                w.errors.append(traceback.format_exc())
        w.attempted += units
        if in_flight <= 1:
            if timed:
                ready = torch.cuda.Event(enable_timing=True)
                ready.record()
                sync(device)
                w.latencies_s.append(due.elapsed_time(ready) * 1e-3)
            else:
                sync(device)
                now = time.perf_counter()
                w.latencies_s.append(now - due)
                due = now
        elif device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            pending.append(event)
            if len(pending) >= in_flight:
                pending.popleft().synchronize()
        if out is not None:
            w.ok_calls_bits += info_bits
            samples.offer((index, out))
        w.calls += 1
        if prof is not None and w.calls == trace_to:
            sync(device)
            window_range.__exit__(None, None, None)
            prof.stop()
            traced, prof = prof, None
            if not timed:
                due = time.perf_counter()
    sync(device)
    w.window_s = time.perf_counter() - w.t_start
    if trace:
        w.trace = summarize(traced.events(), trace_to - trace_from)
    return w, samples.items
