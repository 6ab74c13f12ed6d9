"""The least-work count against hand arithmetic, and its independence of
the decode path."""
import math

from portbench import generate, work
from portbench.entries import decode_batch_tp, decode_soft_llr, serve_tiled
from portbench.reference.conv import Trellis

CCSDS = {"code": {"k": 7, "polys": ["171", "133"], "puncture": None, "termination": "zero"},
         "rho": 2, "registry": "ccsds-k7"}


def test_acs_step_by_hand():
    tr = Trellis(7, (0o171, 0o133), 2)
    # 16 distinct columns of 4 nonzero weights: 64 multiply-adds; 64
    # states x (4 adds + 3 maxima) = 448; the renorm's max and subtraction 127
    assert work.acs_step(tr) == work.Work(639.0, 0.0, 0.0)
    # log domain: 64 x 8 more operations and 64 x 3 exponentials
    assert work.acs_step(tr, "logprob") == work.Work(1151.0, 192.0, 0.0)
    # the combine: 64 adds, then per bit 62 + 64 + 62 + 2 + 2 + 1 = 193
    assert work.combine_step(tr) == work.Work(64.0 + 2 * 193, 2 * 62.0, 0.0)


def test_least_time_of_a_small_shape_by_hand():
    traffic = {"frames": 2, "stages": 1024, "zero_tail": False, "ebn0_db": 4.0}
    batch = generate.draw(CCSDS, traffic, 3, 0, "cpu")
    w = serve_tiled.work(CCSDS, traffic, batch)
    steps = 2 * 1024 // 2
    assert w.f32_ops == 639 * steps
    assert w.bytes == 4 * (2 * 1024 * 2) + 4 * (2 * 1024)
    assert math.isclose(w.least_time_s(), max(639 * steps / 33.45408e12, w.bytes / 3.35e12))
    # 319.5 instructions a stage (9.5 ps) against 12 bytes (3.6 ps)
    assert w.bound_by() == "f32 operations"


def test_work_does_not_depend_on_the_decode_path():
    traffic = {"frames": 4, "stages": 4096, "zero_tail": True, "ebn0_db": 4.0}
    batch = generate.draw(CCSDS, traffic, 5, 0, "cpu")
    assert serve_tiled.work(CCSDS, traffic, batch) == decode_batch_tp.work(CCSDS, traffic, batch)
    soft = decode_soft_llr.work(CCSDS, traffic, batch)
    tr = Trellis(7, (0o171, 0o133), 2)
    per = work.acs_step(tr, "logprob").scaled(2) + work.combine_step(tr)
    assert soft.f32_ops == per.f32_ops * 4 * 4096 // 2
    assert soft.sfu_ops == per.sfu_ops * 4 * 4096 // 2


def test_cell_shapes_least_times():
    tr = Trellis(7, (0o171, 0o133), 2)
    steps = 512 * 65536 // 2
    t = work.acs_step(tr).scaled(steps).least_time_s()
    assert math.isclose(t, 639 * steps / 33.45408e12)  # 0.320 ms, above the bytes' 0.120
    dvb = 512 * 57344 // 2 * 639 / 33.45408e12
    assert 0.28e-3 < dvb < 0.29e-3
    # the instruction rate, half the data sheet's 67e12 that counts an FMA as two
    assert math.isclose(work.F32_OPS, 33.45408e12)
    assert work.SFU_OPS == 16 * 132 * 1.98e9
