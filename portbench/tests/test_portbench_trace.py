"""The trace arithmetic (union, gaps, labels) and the metric readers on
synthetic samples and intervals."""
import dataclasses
import statistics

import pytest
from torch.autograd import DeviceType

from portbench import trace
from portbench.harness import RunContext
from portbench.metrics import (decode_p95_ms, decoded_Mbps, device_idle_frac,
                               kernels_per_call, kernels_roofline, setup_s)
from portbench.work import F32_OPS, Work


def test_merge_and_gaps():
    merged = trace.merge([(5, 7), (0, 2), (1, 3), (6, 9), (9, 9)])
    assert merged == [(0, 3), (5, 9)]
    assert trace.gaps(merged, -1, 12) == [(-1, 0), (3, 5), (9, 12)]
    assert trace.gaps(merged, 1, 6) == [(3, 5)]
    assert trace.gaps([], 0, 4) == [(0, 4)]


def test_innermost_labels_nested_spans():
    spans = [(0, 100, "call"), (10, 40, "traceback"), (12, 20, "aten::index"),
             (50, 60, "aten::item"), (55, 58, "cudaStreamSynchronize")]
    points = [15, 30, 45, 56, 59, 150, 5]
    assert trace.innermost(spans, points) == [
        "aten::index", "traceback", "call", "cudaStreamSynchronize",
        "aten::item", None, "call"]


@dataclasses.dataclass
class _Range:
    start: float
    end: float

    def elapsed_us(self):
        return self.end - self.start


@dataclasses.dataclass
class _Event:
    name: str
    device_type: object
    time_range: _Range
    thread: int = 1


def _ev(name, s, e, dev=DeviceType.CPU, thread=1):
    return _Event(name, dev, _Range(s, e), thread)


def test_summarize_synthetic_trace():
    cuda = DeviceType.CUDA
    events = [
        _ev("portbench.window", 100, 1100),
        _ev("portbench.call", 100, 600), _ev("portbench.call", 600, 1100),
        _ev("aten::index", 120, 200), _ev("aten::item", 600, 700),
        _ev("other thread op", 100, 1100, thread=2),
        _ev("portbench.window", 100, 1100, dev=cuda),  # the range's device image
        _ev("K2", 200, 500, dev=cuda), _ev("K2", 700, 1000, dev=cuda),
        _ev("gather", 450, 520, dev=cuda), _ev("Memcpy DtoD", 1000, 1050, dev=cuda),
        _ev("before", 0, 90, dev=cuda),
    ]
    s = trace.summarize(events, calls=2)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((320 + 350) * 1e-6)  # [200, 520) and [700, 1050)
    assert s.kernels == 3 and s.kernel_s == pytest.approx(670e-6)
    assert s.device_ops[0] == ["K2", pytest.approx(600e-6)]
    # gaps [100, 200) under aten::index, [520, 700) at 610 under aten::item,
    # [1050, 1100) under the second call
    assert dict(s.idle_gaps) == {
        "aten::index": pytest.approx(100e-6), "aten::item": pytest.approx(180e-6),
        "portbench.call": pytest.approx(50e-6)}


def _ctx(**kw):
    base = dict(calls=4, window_s=2.0, info_bits=8_000_000, latencies_s=[0.1] * 4,
                setup_s=7.5, work=Work(F32_OPS * 1e-3, 0.0, 0.0), trace=None)
    base.update(kw)
    return RunContext(**base)


def test_rate_p95_and_setup_readers():
    assert decoded_Mbps.read(_ctx()) == pytest.approx(4.0)
    lat = [i / 1000 for i in range(1, 201)]  # 1..200 ms
    assert decode_p95_ms.read(_ctx(latencies_s=lat)) == pytest.approx(
        statistics.quantiles(lat, n=100)[94] * 1e3)
    assert decode_p95_ms.read(_ctx(latencies_s=lat)) == pytest.approx(190.95)
    assert decode_p95_ms.read(_ctx(latencies_s=[0.1])) is None
    assert setup_s.read(_ctx()) == 7.5


def test_trace_readers_and_their_silence():
    summary = trace.TraceSummary(window_s=0.5, busy_s=0.4, kernels=30, kernel_s=0.2,
                                 calls=3, device_ops=[], idle_gaps=[])
    ctx = _ctx(trace=summary)
    assert kernels_per_call.read(ctx) == 10
    assert device_idle_frac.read(ctx) == pytest.approx(20.0)
    # 1 ms of least work a call, 3 calls, 200 ms of kernels
    assert kernels_roofline.read(ctx) == pytest.approx(1.5)
    for reader in (kernels_per_call, device_idle_frac, kernels_roofline):
        assert reader.read(_ctx()) is None
