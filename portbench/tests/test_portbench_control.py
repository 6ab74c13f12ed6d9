"""The check that decides ``correct``, driven through the harness on the
CPU at sizes a test run holds (the program's plain versions run for CPU
tensors).  The harness's look for a card is skipped; the rest of a run
is driven as on the card:

- the program as it is comes out correct;
- the control, the plain reference in bfloat16 in the program's place,
  comes out not correct (the hard-decision cells at a lower Eb/N0 than
  the cell's, where a few bfloat16 roundings flip a bit in so few
  stages; on the card, at the cells' own sizes and Eb/N0, see PERF.md);
- the faults a decode can have: an answer altered where it is produced
  (a stream's or frame's bits, since the bit limits leave room for a few
  bits that float32 rounding may flip; or one LLR), half of the batch
  left out.
"""
import time

import pytest
import torch

from portbench import harness
from portbench.readings import control_program

SMALL = {
    "ccsds_tiled_512x64k": dict(frames=3, stages=2048),
    "dvbs_r78_tiled_512x64k": dict(frames=3, kept_llrs=2048),
    "ccsds_tp_16x512k": dict(frames=2, stages=2048),
    "ccsds_soft_256x64k": dict(frames=2, stages=1024),
}
# the controls' own inputs: large and noisy enough that bfloat16 flips bits
CONTROL = {
    "ccsds_tiled_512x64k": dict(frames=32, stages=16384, ebn0_db=1.5),
    "dvbs_r78_tiled_512x64k": dict(frames=32, kept_llrs=16384, ebn0_db=3.0),
    "ccsds_tp_16x512k": dict(frames=4, stages=16384, ebn0_db=2.5),
    "ccsds_soft_256x64k": dict(frames=2, stages=1024),
}
SEED = 2**40 + 3


def _cell(name, **traffic):
    cell = harness.resolve(harness.load_benchmark(), name)
    cell.traffic = {**cell.traffic, "pool": 2, "samples": 2, **traffic}
    return cell


def _run(cell, program=None):
    return harness.run_cell(cell, SEED, 0.05, False, "cpu", time.perf_counter(),
                            program=program)["result"]


@pytest.mark.parametrize("name", list(SMALL))
def test_the_program_comes_out_correct(name):
    result = _run(_cell(name, **SMALL[name]))
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", list(CONTROL))
def test_the_control_comes_out_not_correct(name):
    result = _run(_cell(name, **CONTROL[name]), program=control_program)
    assert not result["correct"], result["checks"]


def _broken(fault):
    def make(cell, batches, device):
        step = cell.entry.build(cell.config, cell.traffic, device)
        return lambda llrs: _faulty(step, llrs, fault)
    return make


def _faulty(step, llrs, fault):
    if fault == "half":  # half of the batch left out
        half = llrs.shape[0] // 2
        out = step(llrs[:half])
        return torch.cat([out, torch.zeros_like(out)[: llrs.shape[0] - half]])
    out = step(llrs).clone()
    if out.dtype.is_floating_point:  # one LLR altered
        out[0, out.shape[1] // 2] += 0.5
    else:  # one answer altered: the first stream's or frame's bits flipped
        out[0] ^= 1
    return out


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("name", list(SMALL))
def test_a_broken_program_comes_out_not_correct(name, fault):
    cell = _cell(name, **SMALL[name])
    result = _run(cell, program=_broken(fault))
    assert not result["correct"], result["checks"]


def test_a_raising_program_counts_failed():
    cell = _cell("ccsds_tiled_512x64k", **SMALL["ccsds_tiled_512x64k"])
    calls = []
    warm_up = max(1, cell.traffic["in_flight"])

    def flaky(cell, batches, device):
        step = cell.entry.build(cell.config, cell.traffic, device)

        def call(llrs):
            calls.append(1)
            if len(calls) == warm_up + 1:  # the first call of the window
                raise RuntimeError("a call that fails in the window")
            return step(llrs)
        return call

    result = _run(cell, program=flaky)
    assert result["failed"] == 3 and not result["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_the_program_on_the_card_comes_out_correct(name):
    # the harness's whole run on the card at small sizes, traced
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = harness.run_cell(_cell(name, **SMALL[name]), SEED, 0.5, True, "cuda",
                           time.perf_counter())
    result = run["result"]
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0 and result["metrics"]
