"""The decode stages of ``repro_torch.obs.trace`` on the CPU: the span
trees and counts of ``decode_batch(time_parallel=True)``,
``decode_soft(output="llr")``, the tiled serve step and WAVA (the batch
serve step and ``decode_batch`` of tail-biting blocks) with a recorder
installed as the default, the ``repro_torch.*`` ranges and totals under
``torch.profiler``, the no-op path with neither, outputs unchanged by
tracing, the host-sync counts of the front door, and the engine's
``--metrics-jsonl`` log nesting the stages under ``engine.dispatch``."""
import json

import numpy as np
import pytest
import torch

from repro_torch.obs import trace as rt
from tests._torch_serving import _llrs


@pytest.fixture(autouse=True)
def _no_tracing_left():
    """Each test starts and ends with the null default recorder and empty
    totals."""
    prev = rt.set_default_recorder(None)
    rt.reset_stage_totals()
    yield
    rt.set_default_recorder(prev)
    rt.reset_stage_totals()
    assert not rt._OPEN


def _decoder(code, **kw):
    from repro_torch.core.decoder import ViterbiDecoder

    return ViterbiDecoder.from_standard(code, device="cpu", **kw)


def _frames(code, n_frames, n_bits, seed=5):
    return torch.from_numpy(
        np.stack([_llrs(code, n_bits, seed + i) for i in range(n_frames)]))


def _tree(rec):
    """{stage name: [span, ...]} of the recorder's spans, and the root."""
    by_name = {}
    for sp in rec.spans:
        by_name.setdefault(sp.name.removeprefix("repro_torch."), []).append(sp)
    (root,) = by_name["decode"]
    return by_name, root


def _children(rec, span):
    return [c.name.removeprefix("repro_torch.") for c in
            sorted(rec.children(span), key=lambda c: c.id)]


def _call(kind):
    """(a call, the stage names directly under ``decode`` in order, the
    expected steps by stage) for one decode path on small inputs."""
    from repro_torch.core.kernel_geometry import pick_transfer_tile

    if kind == "time_parallel":  # 512 radix steps
        dec, llrs = _decoder("ccsds-k7"), _frames("ccsds-k7", 2, 1024)
        tt = pick_transfer_tile(512)
        return (lambda: dec.decode_batch(llrs, time_parallel=True),
                ["front_door", "k3", "scan", "recovery", "scan", "traceback"],
                {"traceback": tt})
    if kind == "soft":  # 256 radix steps
        dec, llrs = _decoder("ccsds-k7"), _frames("ccsds-k7", 2, 512)
        tt = pick_transfer_tile(256)
        return (lambda: dec.decode_soft(llrs, output="llr"),
                ["front_door", "k3", "scan", "scan", "alpha", "beta", "llr_combine"],
                {"alpha": tt, "beta": tt - 1})
    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.serve.step import make_viterbi_serve_step

    code = "dvb-s-r78" if kind == "tiled_r78" else "ccsds-k7"
    step = make_viterbi_serve_step(config_for_standard(code), mode="tiled",
                                   one_pass=True, device="cpu")
    if kind == "tiled_r78":
        # the stretched 56-stage overlap: two-pass windows of 88 steps
        return (lambda: step(_frames(code, 2, 1344, seed=9)),
                ["front_door", "window_gather", "k1", "traceback"],
                {"traceback": (64 + 2 * 56) // 2})
    return (lambda: step(_frames(code, 2, 1024, seed=9)),
            ["front_door", "window_gather", "k2"], {})


KINDS = ["time_parallel", "soft", "tiled_r78", "tiled_ccsds"]


@pytest.mark.parametrize("kind", KINDS)
def test_span_tree_and_steps_under_a_default_recorder(kind):
    call, below, steps = _call(kind)
    rec = rt.SpanRecorder()
    rt.set_default_recorder(rec)
    call()
    by_name, root = _tree(rec)
    assert root.parent is None and rec.open_spans == 0
    assert _children(rec, root) == below
    if "recovery" in below:
        (recovery,) = by_name["recovery"]
        assert _children(rec, recovery) == ["k1"]
    for name, want in steps.items():
        assert [sp.attrs["steps"] for sp in by_name[name]] == [want]
    totals = rt.stage_totals()
    assert set(totals) == {sp.name.removeprefix("repro_torch.") for sp in rec.spans}
    assert all(set(t) == {"device_s", "steps", "circulations", "host_syncs"}
               for t in totals.values())
    assert sum(t["steps"] for t in totals.values()) == sum(steps.values())
    assert all(t["device_s"] == 0.0 for t in totals.values())  # no card here


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 31, 32, 33, 100])
def test_scan_is_one_stage_whatever_its_depth(n):
    """``associative_scan`` opens one ``scan`` stage a call, never one a
    level of its recursion; odd lengths scan in reverse."""
    from repro_torch.core.timeparallel import associative_scan

    reverse = n % 2 == 1
    x = torch.arange(float(n))
    rec = rt.SpanRecorder()
    rt.set_default_recorder(rec)
    out = associative_scan(lambda a, b: a + b, x, reverse=reverse)
    want = torch.cumsum(x.flip(0), 0).flip(0) if reverse else torch.cumsum(x, 0)
    assert torch.equal(out, want)
    assert [sp.name for sp in rec.spans] == ["repro_torch.scan"]
    assert rt.stage_totals() == {
        "scan": {"device_s": 0.0, "steps": 0, "circulations": 0, "host_syncs": 0}}


def _wava_call(kind):
    """A WAVA decode of 4 ``lte-tbcc`` blocks of 64 bits (32 radix steps):
    through the batch serve step, or through ``decode_batch``."""
    llrs = _frames("lte-tbcc", 4, 64, seed=11)
    if kind == "serve_batch":
        from repro_torch.configs.viterbi_k7 import config_for_standard
        from repro_torch.serve.step import make_viterbi_serve_step

        step = make_viterbi_serve_step(config_for_standard("lte-tbcc"), mode="batch",
                                       device="cpu")
        return lambda: step(llrs)
    dec = _decoder("lte-tbcc")
    return lambda: dec.decode_batch(llrs)


WAVA_KINDS = ["serve_batch", "decode_batch"]


@pytest.mark.parametrize("kind", WAVA_KINDS)
def test_wava_is_one_decode_root_with_its_circulations(kind):
    call = _wava_call(kind)
    rec = rt.SpanRecorder()
    rt.set_default_recorder(rec)
    call()
    by_name, root = _tree(rec)  # exactly one root
    assert root.parent is None and root.attrs["path"] == "wava" and rec.open_spans == 0
    assert _children(rec, root) == ["front_door", "wava"]
    (wava,) = by_name["wava"]
    assert wava.attrs["circulations"] == 4
    assert _children(rec, wava) == ["k1", "traceback"] * 4
    assert [sp.attrs["steps"] for sp in by_name["traceback"]] == [32] * 4
    totals = rt.stage_totals()
    assert totals["wava"]["circulations"] == 4
    assert sum(t["circulations"] for t in totals.values()) == 4
    assert sum(t["steps"] for t in totals.values()) == 4 * 32
    assert totals["front_door"]["host_syncs"] == 1


@pytest.mark.parametrize("kind", WAVA_KINDS)
def test_wava_stages_add_no_host_sync(kind, monkeypatch):
    """The stages count the reads the call makes and make none: the same
    ``.item()`` reads with the stages on and off, all of them counted."""
    call = _wava_call(kind)
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: reads.append(1) or item(self))
    off = call()
    n_off = len(reads)
    rt.set_default_recorder(rt.SpanRecorder())
    on = call()
    assert len(reads) - n_off == n_off == 1
    assert sum(t["host_syncs"] for t in rt.stage_totals().values()) == n_off
    assert torch.equal(on, off)


@pytest.mark.parametrize("kind", WAVA_KINDS)
def test_wava_ranges_and_totals_under_the_profiler(kind):
    call = _wava_call(kind)
    off = call()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = call()
    names = {e.name for e in prof.events() if e.name.startswith("repro_torch.")}
    assert names == {"repro_torch." + s for s in
                     ["decode", "front_door", "wava", "k1", "traceback"]}
    totals = rt.stage_totals()
    assert totals["wava"]["circulations"] == 4 and totals["traceback"]["steps"] == 128
    assert torch.equal(on, off)


def test_the_profiler_range_class_exists():
    """The stages open ``torch._C._profiler._RecordFunctionFast``, a
    private class: a torch without it fails here, not in a traced run."""
    assert hasattr(torch._C._profiler, "_RecordFunctionFast")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rt.stage("probe"):
            torch.ones(2).sum()
    assert "repro_torch.probe" in {e.name for e in prof.events()}


@pytest.mark.parametrize("kind", KINDS)
def test_profiler_ranges_and_totals_without_a_recorder(kind):
    call, below, steps = _call(kind)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    names = {e.name for e in prof.events() if e.name.startswith("repro_torch.")}
    nested = ["k1"] if "recovery" in below else []
    assert names == {"repro_torch." + s for s in ["decode", *below, *nested]}
    totals = rt.stage_totals()
    assert set(totals) == {n.removeprefix("repro_torch.") for n in names}
    assert sum(t["steps"] for t in totals.values()) == sum(steps.values())
    # the session is over: the stages are off again
    assert rt.stage("decode") is rt._NULL_SPAN


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_bit_identical_with_tracing_on_and_off(kind):
    call, _, _ = _call(kind)
    off = call()
    rt.set_default_recorder(rt.SpanRecorder())
    on = call()
    rt.set_default_recorder(None)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = call()
    assert torch.equal(on, off) and torch.equal(profiled, off)


def test_stages_are_the_shared_null_span_when_off():
    call, _, _ = _call("tiled_r78")
    assert not rt.default_recorder().enabled
    assert rt.stage("decode", device=torch.device("cpu"), steps=3) is rt._NULL_SPAN
    call()
    assert rt.stage_totals() == {}
    assert rt.host_read(torch.tensor(2.5)) == 2.5 and rt.stage_totals() == {}


def test_set_default_recorder_returns_the_previous_one():
    rec = rt.SpanRecorder()
    prev = rt.set_default_recorder(rec)
    assert isinstance(prev, rt.NullRecorder) and rt.default_recorder() is rec
    assert rt.set_default_recorder(None) is rec
    assert isinstance(rt.default_recorder(), rt.NullRecorder)


@pytest.mark.parametrize("kind,want", [
    ("strict", 1),            # isfinite(llrs).all()
    ("sanitize", 3),          # ... and the nan and clamped counts
    ("no_renorm", 2),         # ... and the headroom check's max|llr|
])
def test_front_door_counts_its_host_syncs(kind, want):
    from repro_torch.core.viterbi import AcsPrecision

    kw = {"sanitize": True} if kind == "sanitize" else {}
    if kind == "no_renorm":
        kw["precision"] = AcsPrecision(renorm=False)
    dec = _decoder("ccsds-k7", **kw)
    rec = rt.SpanRecorder()
    rt.set_default_recorder(rec)
    dec.decode_batch(_frames("ccsds-k7", 2, 256))
    (front,) = rec.find("repro_torch.front_door")
    assert front.attrs["host_syncs"] == want
    totals = rt.stage_totals()
    assert totals["front_door"]["host_syncs"] == want
    assert sum(t["host_syncs"] for t in totals.values()) == want


def test_soft_path_counts_its_uploads():
    """The soft path's pageable uploads (three step operands each for
    alpha and beta, two operands of the LLR combine) count as host
    syncs of their stages."""
    call, _, _ = _call("soft")
    rt.set_default_recorder(rt.SpanRecorder())
    call()
    totals = rt.stage_totals()
    got = {s: totals[s]["host_syncs"] for s in ("front_door", "alpha", "beta", "llr_combine")}
    assert got == {"front_door": 1, "alpha": 3, "beta": 3, "llr_combine": 2}


def test_strict_rejection_keeps_the_count_and_closes_the_stages():
    from repro_torch.core.validate import InvalidInputError

    dec = _decoder("ccsds-k7")
    llrs = _frames("ccsds-k7", 2, 256)
    llrs[0, 3, 1] = float("nan")
    rec = rt.SpanRecorder()
    rt.set_default_recorder(rec)
    with pytest.raises(InvalidInputError):
        dec.decode_batch(llrs)
    (front,) = rec.find("repro_torch.front_door")
    (root,) = rec.find("repro_torch.decode")
    assert front.parent == root.id and "InvalidInputError" in front.attrs["error"]
    assert front.attrs["host_syncs"] == 3 and rec.open_spans == 0


def test_host_reads_count_in_the_innermost_stage_only():
    rt.set_default_recorder(rt.SpanRecorder())
    x = torch.arange(4.0)
    assert rt.host_read(x.sum()) == 6.0  # outside every stage: not counted
    with rt.stage("outer"):
        rt.host_read(x.max())
        with rt.stage("inner", steps=2):
            rt.host_read(x.min())
            rt.host_upload(np.ones(3, np.float32), torch.device("cpu"))
        assert rt.host_read(np.float32(1.5)) == 1.5  # no tensor: no sync
    totals = rt.stage_totals()
    assert totals["outer"]["host_syncs"] == 1 and totals["inner"]["host_syncs"] == 2
    assert totals["inner"]["steps"] == 2 and totals["outer"]["steps"] == 0


def test_engine_metrics_jsonl_nests_the_stages_under_dispatch(tmp_path, capsys):
    from repro_torch.launch import serve

    jsonl = tmp_path / "m.jsonl"
    serve.main(["--service", "engine", "--streams", "8", "--stream-len", "1024",
                "--batches", "2", "--ebn0", "12", "--device", "cpu",
                "--metrics-jsonl", str(jsonl)])
    capsys.readouterr()
    spans = [r for r in map(json.loads, jsonl.read_text().splitlines())
             if r["type"] == "span"]
    by_id = {r["id"]: r for r in spans}
    decodes = [r for r in spans if r["name"] == "repro_torch.decode"]
    assert decodes
    for r in decodes:
        assert by_id[r["parent"]]["name"] == "engine.dispatch"
        assert r["attrs"]["path"]
    fronts = [r for r in spans if r["name"] == "repro_torch.front_door"]
    assert {by_id[r["parent"]]["name"] for r in fronts} == {"repro_torch.decode"}
    # the launcher put the previous default back
    assert not rt.default_recorder().enabled
