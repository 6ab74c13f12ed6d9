"""The ``lte-tbcc`` cell: the tail-biting references against brute force
and against the program, the least work by hand, the WAVA readers, and
the check that decides ``correct`` driven through the harness on the CPU
at small sizes."""
import itertools
import time

import pytest
import torch

from portbench import generate, harness, trace, work
from portbench.entries import serve_blocks
from portbench.harness import RunContext
from portbench.readings import control_program
from portbench.reference import conv, tailbiting

CELL = "lte_tbcc_blocks_512kx64"
LTE = (0o133, 0o171, 0o165)
SEED = 2**40 + 11


def _config():
    return harness.resolve(harness.load_benchmark(), CELL).config


@pytest.mark.parametrize("rho,n", [(1, 7), (1, 9), (2, 8), (2, 10), (2, 12)])
def test_ml_decode_is_the_best_of_every_message(rho, n):
    tr = conv.Trellis(7, LTE, rho)
    gen = torch.Generator().manual_seed(n)
    llrs = torch.randn((10, n, 3), generator=gen) * 2 + 0.5
    messages = torch.tensor(list(itertools.product((0, 1), repeat=n)), dtype=torch.uint8)
    signs = 1.0 - 2.0 * conv.encode(messages, 7, LTE, tail_biting=True).to(torch.float64)
    scores = torch.einsum("mnb,fnb->fm", signs, llrs.to(torch.float64))
    bits = tailbiting.ml_decode(llrs, tr, block_frames=4)  # three blocks, the last short
    assert torch.equal(bits.to(torch.int64), messages[scores.argmax(dim=1)].to(torch.int64))


@pytest.mark.parametrize("ebn0_db", [1.0, 3.0])
def test_the_wava_reference_is_the_programs_decode(ebn0_db):
    from repro_torch.core.decoder import ViterbiDecoder

    config = _config()
    traffic = {"frames": 96, "stages": 64, "zero_tail": False, "ebn0_db": ebn0_db}
    batch = generate.draw(config, traffic, SEED, 0, "cpu")
    program = ViterbiDecoder.from_standard("lte-tbcc", device="cpu").decode_tailbiting(
        batch.llrs)[0]
    tr = conv.Trellis(7, LTE, 2)
    assert torch.equal(tailbiting.wava_decode(batch.llrs, tr, 4, block_frames=40), program)
    # WAVA departs from the ML decode at these Eb/N0 (the cell's limit allows it)
    assert not torch.equal(tailbiting.ml_decode(batch.llrs, tr), program)


def test_work_by_hand():
    config = _config()
    traffic = {"frames": 2, "stages": 8, "zero_tail": False, "ebn0_db": 3.0}
    batch = generate.draw(config, traffic, 3, 0, "cpu")
    w = serve_blocks.work(config, traffic, batch)
    # a step: 64 distinct columns of 6 nonzero weights (384 multiply-adds),
    # 64 states x (4 adds + 3 maxima) = 448, the renorm's 127; 2 x 8 / 2 steps
    assert work.acs_step(conv.Trellis(7, LTE, 2)) == work.Work(959.0, 0.0, 0.0)
    assert w.f32_ops == 959 * 8
    # 2 x 8 x 3 float32 LLRs read, 2 x 8 int32 bits written
    assert w.bytes == 4 * 48 + 4 * 16
    assert w.bound_by() == "f32 operations"


def _ctx(totals_calls=2):
    summary = trace.TraceSummary(window_s=1.0, busy_s=0.9, kernels=10, kernel_s=0.5,
                                 calls=totals_calls, device_ops=[], idle_gaps=[])
    return RunContext(calls=10, window_s=2.0, info_bits=1, latencies_s=[0.1] * 10,
                      setup_s=1.0, work=work.Work(1.0, 0.0, 0.0), trace=summary)


@pytest.mark.parametrize("name,want", [("wava_circulations_per_call", 4.0), ("wava_ms", 30.0)])
def test_wava_readers(name, want, monkeypatch):
    from repro_torch.obs import trace as rt

    from portbench.harness import reader

    wava = {"device_s": 0.06, "steps": 0, "circulations": 8, "host_syncs": 0}
    back = {"device_s": 0.02, "steps": 256, "circulations": 0, "host_syncs": 0}
    monkeypatch.setattr(rt, "stage_totals", lambda: {"wava": dict(wava), "traceback": dict(back)})
    assert reader(name)(_ctx()) == pytest.approx(want)
    # silent where WAVA did not run, where nothing was traced, and on a
    # program from before the ``wava`` stage
    monkeypatch.setattr(rt, "stage_totals", lambda: {"traceback": dict(back)})
    assert reader(name)(_ctx()) is None
    assert reader(name)(_ctx(totals_calls=0)) is None
    monkeypatch.delattr(rt, "stage_totals")
    assert reader(name)(_ctx()) is None


def _cell(**traffic):
    cell = harness.resolve(harness.load_benchmark(), CELL)
    cell.traffic = {**cell.traffic, "pool": 2, "samples": 2, **traffic}
    return cell


def _run(cell, program=None):
    return harness.run_cell(cell, SEED, 0.05, False, "cpu", time.perf_counter(),
                            program=program)["result"]


def _broken(fault):
    def make(cell, batches, device):
        step = cell.entry.build(cell.config, cell.traffic, device)

        def call(llrs):
            if fault == "half":  # half of the batch left out
                half = llrs.shape[0] // 2
                out = step(llrs[:half])
                return torch.cat([out, torch.zeros_like(out)[: llrs.shape[0] - half]])
            out = step(llrs).clone()
            out[0] ^= 1  # the first block's bits flipped
            return out
        return call
    return make


def test_the_program_comes_out_correct():
    result = _run(_cell(frames=512))
    assert result["correct"], result["checks"]
    assert result["checks"]["wava_bits_differing"]["value"] == 0


def test_the_control_comes_out_not_correct():
    result = _run(_cell(frames=8192), program=control_program)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_program_comes_out_not_correct(fault):
    result = _run(_cell(frames=512), program=_broken(fault))
    assert not result["correct"], result["checks"]
