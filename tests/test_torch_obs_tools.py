"""The observability tools and the gate mains: ``repro_torch.obs``'s
``Observability``, ``obs.top`` and ``obs.smoke``, and the
``runtime.chaos_smoke`` and ``verify.scrub_smoke`` gates, against the
reference's counterparts.

``Observability`` writes the same JSONL lines as the reference's on the
same calls (an injected clock); ``parse_prometheus`` and
``render_snapshot`` give the same results on the same registry text and
snapshot; ``demo_workload`` completes the reference's tickets with the
same bits.  The gate mains run on the CPU and must exit 0.
"""
import json

import numpy as np
import pytest


def _clock():
    t = [0.0]

    def tick():
        t[0] += 0.25
        return t[0]
    return tick


def _observe(pkg, tmp_path, name):
    """One traced unit of work through ``pkg.obs.Observability``: a
    nested span, an event, two metrics; the JSONL lines it writes."""
    import importlib

    obs_mod = importlib.import_module(f"{pkg}.obs")
    path = tmp_path / f"{name}.jsonl"
    obs = obs_mod.Observability(jsonl=str(path), clock=_clock())
    assert obs.enabled
    obs.registry.counter("engine_requests_total", "requests").inc(
        3, event="submitted")
    obs.registry.histogram("engine_sojourn_seconds", "sojourn").observe(
        0.003, slo="latency")
    with obs.recorder.span("engine.batch", code="ccsds-k7"):
        with obs.recorder.span("engine.dispatch", path="batch"):
            obs.recorder.event("engine.retry", attempt=1)
    obs.close()
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_observability_writes_the_reference_lines(tmp_path):
    ours = _observe("repro_torch", tmp_path, "ours")
    ref = _observe("repro", tmp_path, "ref")
    assert ours == ref
    assert [x["type"] for x in ours][-1] == "metrics"
    assert {x["name"] for x in ours if x["type"] == "span"} == {
        "engine.batch", "engine.dispatch"}


def test_observability_disabled_and_without_sink(tmp_path):
    from repro_torch.obs import (
        MetricsRegistry,
        NullRecorder,
        Observability,
        SpanRecorder,
    )

    off = Observability(enabled=False, jsonl=str(tmp_path / "never.jsonl"))
    assert isinstance(off.recorder, NullRecorder) and not off.enabled
    assert off.sink is None and isinstance(off.registry, MetricsRegistry)
    off.dump_metrics()
    off.close()
    assert not (tmp_path / "never.jsonl").exists()
    reg = MetricsRegistry()
    on = Observability(registry=reg)
    assert on.registry is reg and isinstance(on.recorder, SpanRecorder)
    assert on.sink is None
    on.close()


@pytest.fixture(scope="module")
def workloads():
    """The demo workload through both packages' engines on the CPU."""
    from repro.obs.top import demo_workload as ref_demo

    from repro_torch.obs.top import demo_workload

    return demo_workload(device="cpu"), ref_demo()


def test_demo_workload_tickets_equal_the_reference(workloads):
    (eng, done), (ref_eng, ref_done) = workloads
    assert len(done) == len(ref_done) == 60
    for t, w in zip(done, ref_done):
        assert (t.id, t.path, t.cell, t.slo, t.error) == (
            w.id, w.path, w.cell, w.slo, w.error)
        np.testing.assert_array_equal(t.bits, np.asarray(w.bits))
    assert eng.device.type == "cpu"


def test_parse_prometheus_on_the_port_registry(workloads):
    from repro.obs.smoke import parse_prometheus as ref_parse

    from repro_torch.obs.smoke import parse_prometheus

    (eng, _), (ref_eng, _) = workloads
    text = eng.registry.render_prometheus()
    fams = parse_prometheus(text)
    assert fams == ref_parse(text)
    assert fams == parse_prometheus(ref_eng.registry.render_prometheus())
    for fam in ("engine_requests_total", "engine_batches_total",
                "engine_sojourn_seconds"):
        assert fams[fam]["samples"]
    for bad in ("no_type 1\n",
                "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n",
                "# TYPE c counter\nc{a=b} 1\n",
                "# TYPE c gauge_like\n"):
        with pytest.raises(ValueError):
            parse_prometheus(bad)
        with pytest.raises(ValueError):
            ref_parse(bad)


def test_render_snapshot_gives_the_reference_text(workloads):
    from repro.obs.top import render_snapshot as ref_render

    from repro_torch.obs.top import render_snapshot

    (eng, _), (ref_eng, _) = workloads
    eng.stats()
    ref_eng.stats()
    for snap in (eng.registry.snapshot(), ref_eng.registry.snapshot()):
        text = render_snapshot(snap)
        assert text == ref_render(snap)
        assert text.startswith("requests  submitted=60 completed=60")
    # the integrity line and the empty renders
    snap = {"engine_scrub_total": {"series": [
        {"labels": {"event": "frames"}, "value": 8.0},
        {"labels": {"event": "syndrome_flag"}, "value": 2.0}]},
        "engine_quarantined_total": {"series": [{"labels": {}, "value": 1.0}]}}
    assert render_snapshot(snap) == ref_render(snap)
    assert "integrity scrubbed=8 flags=2 sdc=0 quarantined=1" in render_snapshot(snap)
    assert render_snapshot({}) == ref_render({})


def test_top_main_renders_jsonl_and_demo(tmp_path, capsys):
    from repro_torch.obs import Observability
    from repro_torch.obs import top

    path = tmp_path / "m.jsonl"
    obs = Observability(jsonl=str(path))
    obs.registry.counter("engine_requests_total", "r").inc(2, event="submitted")
    obs.close()
    assert top.main(["--jsonl", str(path)]) == 0
    assert capsys.readouterr().out.startswith("requests  submitted=2 completed=0")
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"type": "span", "name": "x"}) + "\n")
    assert top.main(["--jsonl", str(empty)]) == 1
    assert top.main(["--demo", "--device", "cpu"]) == 0
    assert "ccsds-k7" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        top.main([])


@pytest.mark.parametrize("module", ["repro_torch.obs.smoke",
                                    "repro_torch.runtime.chaos_smoke",
                                    "repro_torch.verify.scrub_smoke"])
def test_gate_mains_exit_zero_on_the_cpu(module, capsys):
    import importlib

    argv = ["--device", "cpu"] + (["--reps", "15"] if module.endswith("obs.smoke") else [])
    assert importlib.import_module(module).main(argv) == 0
    out = capsys.readouterr().out
    assert {"repro_torch.obs.smoke": "obs-smoke OK",
            "repro_torch.runtime.chaos_smoke": "[chaos-smoke] PASS",
            "repro_torch.verify.scrub_smoke": "[sdc-smoke] PASS"}[module] in out


def test_obs_smoke_check_spans_rejects_a_broken_nesting():
    from repro_torch.obs import SpanRecorder
    from repro_torch.obs.smoke import _check_spans

    rec = SpanRecorder(clock=_clock())
    with rec.span("engine.batch"):
        with rec.span("engine.assemble"):
            pass
    with pytest.raises(AssertionError, match="missing children"):
        _check_spans(rec)
    with pytest.raises(AssertionError, match="no engine.batch"):
        _check_spans(SpanRecorder())
