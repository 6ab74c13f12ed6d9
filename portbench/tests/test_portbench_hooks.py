"""What a later cell adds as files: a termination the generator honours,
an entry's own ``draw``, a loop named by the traffic, and what a loop
measures reaching a metric's reader."""
import sys
import time
import types

import pytest
import torch

from portbench import generate, harness
from portbench.loops import closed
from portbench.reference import conv

TBCC = {"code": {"k": 7, "polys": ["133", "171", "165"], "puncture": None,
                 "termination": "tailbiting"}, "rho": 1}
TRAFFIC = {"frames": 3, "stages": 40, "zero_tail": False, "ebn0_db": 40.0}


def test_tail_biting_frames_end_in_the_state_they_start_in():
    batch = generate.draw(TBCC, TRAFFIC, 2**40 + 1, 0, "cpu")
    info = batch.info
    coded = conv.encode(info, 7, (0o133, 0o171, 0o165), tail_biting=True)
    # a tail-biting codeword turns with its information bits
    turned = conv.encode(info.roll(5, dims=1), 7, (0o133, 0o171, 0o165), tail_biting=True)
    assert torch.equal(turned, coded.roll(5, dims=1))
    # at 40 dB every LLR has the coded bit's sign; the whole frame is information
    assert torch.equal((batch.llrs < 0).to(torch.uint8), coded)
    assert batch.n_info == batch.n_stages == 40
    zero_start = conv.encode(info, 7, (0o133, 0o171, 0o165))
    assert not torch.equal(zero_start, coded)


@pytest.mark.parametrize("termination,tail", [("tailbiting", True), ("truncated", False)])
def test_a_termination_the_generator_does_not_make_raises(termination, tail):
    config = {**TBCC, "code": {**TBCC["code"], "termination": termination}}
    with pytest.raises(ValueError):
        generate.draw(config, {**TRAFFIC, "zero_tail": tail}, 1, 0, "cpu")


@pytest.fixture
def probes(monkeypatch):
    """A loop and a metric registered by name, as files would be."""
    loop = types.ModuleType("portbench.loops.probe")

    def run(step, batches, traffic, seconds, seed, trace, device, info_bits):
        w, samples = closed.run(step, batches, traffic, seconds, seed, trace, device, info_bits)
        w.extra["probe"] = w.calls
        return w, samples

    loop.run = run
    metric = types.ModuleType("portbench.metrics.probe_calls")
    metric.read = lambda ctx: ctx.extra.get("probe")
    monkeypatch.setitem(sys.modules, "portbench.loops.probe", loop)
    monkeypatch.setitem(sys.modules, "portbench.metrics.probe_calls", metric)
    read_json = harness._read_json

    def with_loop(path):
        data = read_json(path)
        return {**data, "loop": "probe"} if path.parent.name == "traffic" else data

    monkeypatch.setattr(harness, "_read_json", with_loop)


def test_the_traffic_names_its_loop_and_the_entry_its_draw(probes):
    cell = harness.resolve(harness.load_benchmark(), "ccsds_tiled_512x64k")
    assert cell.loop is sys.modules["portbench.loops.probe"]
    cell.traffic = {**cell.traffic, "frames": 2, "stages": 512, "pool": 2, "samples": 2}
    drawn = []

    def draw(config, traffic, seed, index, device):
        drawn.append(index)
        return generate.draw(config, traffic, seed, index, device)

    entry = types.SimpleNamespace(**{k: getattr(cell.entry, k) for k in
                                     ("CHECKS", "build", "info_bits", "judge", "work")})
    entry.draw = draw
    cell.entry = entry
    cell.end_to_end = [{"name": "probe_calls", "unit": "calls"}]
    run = harness.run_cell(cell, 7, 0.05, False, "cpu", time.perf_counter())
    assert drawn == [0, 1]
    assert run["result"]["correct"]
    assert run["result"]["metrics"]["probe_calls"]["value"] == run["info"]["calls"] >= 1


def test_the_default_loop_is_closed():
    cell = harness.resolve(harness.load_benchmark(), "ccsds_tp_16x512k")
    assert cell.loop is closed
