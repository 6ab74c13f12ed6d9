"""The per-stage readers (``portbench.stages`` and the metrics that read
the program's ``stage_totals``): silent without a trace and without the
program's totals, the totals over the traced calls otherwise, and every
new entry of ``BENCHMARK.json`` read by one of them."""
import importlib

import pytest
import torch

from portbench import harness, stages, trace
from portbench.harness import RunContext
from portbench.work import Work

READERS = {  # metric module -> (field, stages summed; None: every stage)
    "plain_steps_per_call": ("steps", None),
    "host_syncs_per_call": ("host_syncs", None),
    "traceback_ms": ("device_s", ["traceback"]),
    "scans_ms": ("device_s", ["scan"]),
    "alpha_beta_ms": ("device_s", ["alpha", "beta"]),
    "window_gather_ms": ("device_s", ["window_gather"]),
}
TOTALS = {  # two traced calls' worth
    "decode": {"device_s": 0.4, "steps": 0, "host_syncs": 0},
    "front_door": {"device_s": 0.002, "steps": 0, "host_syncs": 2},
    "window_gather": {"device_s": 0.004, "steps": 0, "host_syncs": 0},
    "traceback": {"device_s": 0.1, "steps": 176, "host_syncs": 0},
    "scan": {"device_s": 0.06, "steps": 0, "host_syncs": 0},
    "alpha": {"device_s": 0.08, "steps": 512, "host_syncs": 6},
    "beta": {"device_s": 0.07, "steps": 510, "host_syncs": 6},
}


def _ctx(calls=2):
    summary = None if calls is None else trace.TraceSummary(
        window_s=1.0, busy_s=0.9, kernels=10, kernel_s=0.5, calls=calls,
        device_ops=[], idle_gaps=[])
    return RunContext(calls=10, window_s=2.0, info_bits=1, latencies_s=[0.1] * 10,
                      setup_s=1.0, work=Work(1.0, 0.0, 0.0), trace=summary)


def _reader(name):
    return importlib.import_module(f"portbench.metrics.{name}").read


@pytest.fixture
def fabricated(monkeypatch):
    from repro_torch.obs import trace as rt

    monkeypatch.setattr(rt, "stage_totals", lambda: {k: dict(v) for k, v in TOTALS.items()})


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_divides_the_totals_by_the_traced_calls(name, fabricated):
    field, names = READERS[name]
    want = sum(t[field] for s, t in TOTALS.items() if names is None or s in names) / 2
    got = _reader(name)(_ctx())
    assert got == pytest.approx(want * 1e3 if field == "device_s" else want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_without_a_trace(name, fabricated):
    assert _reader(name)(_ctx(calls=None)) is None
    assert _reader(name)(_ctx(calls=0)) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_is_silent_without_stage_totals(name, monkeypatch):
    """A program from before the stages has no ``stage_totals``."""
    from repro_torch.obs import trace as rt

    monkeypatch.delattr(rt, "stage_totals")
    assert stages.totals() is None
    assert _reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", ["traceback_ms", "scans_ms", "alpha_beta_ms",
                                  "window_gather_ms"])
def test_stage_reader_is_silent_where_its_stage_did_not_run(name, monkeypatch):
    from repro_torch.obs import trace as rt

    monkeypatch.setattr(rt, "stage_totals", lambda: {"decode": dict(TOTALS["decode"])})
    assert _reader(name)(_ctx()) is None
    monkeypatch.setattr(rt, "stage_totals", lambda: {})
    assert _reader(name)(_ctx()) is None


def test_plain_steps_of_a_profiled_serve_step():
    """The program's own totals under a profiler session: the two-pass
    window path of dvb-s-r78 runs one traceback of 88 steps a call."""
    import numpy as np

    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.obs import trace as rt
    from repro_torch.serve.step import make_viterbi_serve_step

    step = make_viterbi_serve_step(config_for_standard("dvb-s-r78"), mode="tiled",
                                   one_pass=True, device="cpu")
    kept = torch.from_numpy(np.random.default_rng(3).normal(
        2.0, 2.0, (2, 1344 * 8 // 7)).astype(np.float32))
    rt.reset_stage_totals()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(2):
                step(kept)
        assert _reader("plain_steps_per_call")(_ctx(calls=2)) == 88
        assert _reader("host_syncs_per_call")(_ctx(calls=2)) == 1
        assert _reader("window_gather_ms")(_ctx(calls=2)) == 0.0  # no card: no device time
    finally:
        rt.reset_stage_totals()


def test_every_new_entry_has_a_reader_and_reports_what_it_moves():
    bench = harness.load_benchmark()
    names = {m["name"]: m for m in bench["per_layer"]}
    for reader, (_, _) in READERS.items():
        entries = [m for n, m in names.items() if n.split(".")[0] == reader]
        assert entries
        for m in entries:
            assert m["layer"] == "front door and plain stages"
            assert m["source"] == "device_trace" and m["better"] == "lower"
            assert m["moves"] == {"rate": "decoded_Mbps", "latency": "decode_p95_ms"}[
                m["name"].split(".")[1]]
