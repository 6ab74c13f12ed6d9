"""The tooling slice: ``repro_torch.roofline``, ``repro_torch.kernels.traffic``,
``repro_torch.obs.profile`` (and the engine's dispatch spans that carry
it) and ``repro_torch.kernels.parity``, against the reference's.

Traffic bytes and profile bytes, operations and depth are shape
arithmetic and must equal the reference's number for number (its traffic
at ``xla="static"``; the port's ``xla="hlo"`` counts its own plain
stages with ``hlocount``).  The roofline differs
only in its entry: the reference's terms are computed here with
``repro.roofline.HW`` holding the H100 entry's numbers.
"""
import json

import numpy as np
import pytest
import torch

from _torch_serving import _llrs, _requests

PROFILE_CODES = ["ccsds-k7", "wifi-11a-r34", "lte-tbcc", "gsm-cs1"]
PROFILE_PATHS = ("batch", "time_parallel", "stream", "wava", "sharded",
                 "session", "soft")


def _ref_h100():
    from repro.roofline import HW as RefHW

    from repro_torch.roofline import H100

    return RefHW(name=H100.name, peak_flops=H100.peak_flops,
                 hbm_bw=H100.hbm_bw, ici_bw=H100.ici_bw)


def _spec_pair(name):
    from repro.codes.registry import get_code as ref_code

    from repro_torch.codes import get_code

    return get_code(name).spec, ref_code(name).spec


# -- roofline -------------------------------------------------------------------

def test_h100_entry_is_the_data_sheet():
    from repro_torch.roofline import H100, HW

    assert isinstance(H100, HW)
    assert (H100.peak_flops, H100.hbm_bw, H100.ici_bw) == (67e12, 3.35e12, 900e9)
    assert "h100" in H100.name and "700w" in H100.name


@pytest.mark.parametrize("flops,hbm,wire,chips", [
    (1e12, 1e9, 0.0, 1), (1e9, 5e9, 1e8, 4), (3e10, 1e8, 9e9, 8), (0.0, 0.0, 0.0, 1)])
def test_roofline_terms_equal_reference(flops, hbm, wire, chips):
    from repro.roofline import RooflineReport as RefReport

    from repro_torch.roofline import RooflineReport

    kw = dict(arch="viterbi", cell="decode_64k", mesh="frames", n_chips=chips,
              flops_per_device=flops, hbm_bytes_per_device=hbm,
              wire_bytes_per_device=wire, model_flops=0.5 * flops * chips,
              collective_counts={"all-gather": 2})
    got = RooflineReport(**kw)
    want = RefReport(hw=_ref_h100(), **kw)
    assert got.to_dict() == want.to_dict()
    assert got.hw.name == want.hw.name


# -- traffic --------------------------------------------------------------------

TRAFFIC_GRID = [
    (n_stages, n_frames, depth, name, rho)
    for n_stages, n_frames, depth in ((64, 1, 32), (512, 1024, 128),
                                      (2048, 37, 512), (4096, 512, 2048))
    for name, rho in (("ccsds-k7", 2), ("ccsds-k7", 1), ("lte-tbcc", 2),
                      ("gsm-cs1", 2))
]


@pytest.mark.parametrize("n_stages,n_frames,depth,name,rho", TRAFFIC_GRID)
def test_traffic_equals_reference_static(n_stages, n_frames, depth, name, rho):
    """Both stream models, packed and unpacked, at f32 and bf16 operands,
    row for row against the reference's ``xla="static"``."""
    import jax.numpy as jnp
    from repro.core.viterbi import AcsPrecision as RefPrecision
    from repro.kernels import traffic as ref

    from repro_torch.core.viterbi import AcsPrecision
    from repro_torch.kernels import traffic

    spec, rspec = _spec_pair(name)
    for mm, rmm in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        for pack in (False, True):
            kw = dict(n_stages=n_stages, n_frames=n_frames, rho=rho,
                      decision_depth=depth, pack_survivors=pack)
            for fn in ("two_pass_stream_traffic", "one_pass_stream_traffic"):
                got = getattr(traffic, fn)(
                    spec=spec, precision=AcsPrecision(matmul_dtype=mm), **kw)
                want = getattr(ref, fn)(
                    spec=rspec, precision=RefPrecision(matmul_dtype=rmm),
                    xla="static", **kw)
                assert got.row() == want.row(), (fn, mm, pack)
                assert got.total == want.total


@pytest.mark.parametrize("shape", [(512, 1024, 128), (2048, 256, 512)])
def test_traffic_report_equals_reference(shape):
    from repro.kernels import traffic as ref

    from repro_torch.kernels import traffic

    got = traffic.streaming_traffic_report(*shape)
    want = ref.streaming_traffic_report(*shape, xla="static")
    assert got.pop("k2_ring_in_smem") is True
    assert got == want
    assert traffic.streaming_traffic_report(*shape, xla="static")["ratio"] == (
        want["ratio"])


def test_traffic_hlo_mode_counts_the_plain_stages():
    """``xla="hlo"`` counts the plain stages' operation stream with
    ``hlocount.analyze`` on ``meta`` tensors: the kernels' interface bytes
    are the static model's, the one-pass repack (a transpose view and one
    int8 -> int32 cast) is exactly the boundary model's, and the eager
    traceback, which materialises every step, moves more than the
    boundary model charges."""
    from repro_torch.kernels import traffic

    kw = dict(n_stages=128, n_frames=16, decision_depth=32)
    for fn in (traffic.two_pass_stream_traffic, traffic.one_pass_stream_traffic):
        hlo, static = fn(xla="hlo", **kw), fn(xla="static", **kw)
        assert hlo.kernel_bytes == static.kernel_bytes
        assert hlo.breakdown["flush"] > static.breakdown["flush"]
        assert hlo.xla_bytes > 0
        with pytest.raises(ValueError, match="auto|hlo|static"):
            fn(xla="measured")
    one_hlo = traffic.one_pass_stream_traffic(xla="hlo", **kw)
    one_static = traffic.one_pass_stream_traffic(xla="static", **kw)
    assert one_hlo.breakdown["chunk_post"] == one_static.breakdown["chunk_post"]
    assert traffic.one_pass_stream_traffic(xla="auto", **kw) == one_static
    rep = traffic.streaming_traffic_report(xla="hlo")
    assert rep["xla_mode"] == "hlo" and rep["ratio"] > 1.0


def test_k2_ring_placement_is_the_launchers():
    """The premise check asks K2's own geometry: rings in shared memory at
    the acceptance shape, in device memory for a deep int8 ring at the
    streaming geometry (``k2_block_frames``' docstring)."""
    from repro_torch.kernels import traffic

    assert traffic.k2_ring_in_smem()
    assert not traffic.k2_ring_in_smem(
        n_stages=8192, n_frames=512, decision_depth=5120, pack_survivors=False)


def test_traffic_main_prints_the_report(capsys):
    from repro_torch.kernels import traffic

    traffic.main()
    rep = json.loads(capsys.readouterr().out)
    assert rep["xla_mode"] == "static" and rep["ratio"] >= 5.0
    assert rep["k2_ring_in_smem"] is True


# -- dispatch profile -----------------------------------------------------------

@pytest.mark.parametrize("decoder_kw", [
    {}, {"decision_depth": 512}, {"transfer_tile": 32},
    {"use_kernel": False}, {"pack_survivors": True, "use_kernel": False}],
    ids=["default", "depth512", "tile32", "two_pass", "packed"])
@pytest.mark.parametrize("name", PROFILE_CODES)
def test_dispatch_profile_equals_reference(name, decoder_kw):
    """Every route (and an unknown one, which takes the batch model) over
    several cells: bytes, operations and depth equal the reference's; with
    the reference priced on the H100 entry, every attribute and every
    achieved fraction too."""
    from repro.core.decoder import ViterbiDecoder as RefDecoder
    from repro.obs import profile as ref_profile

    from repro_torch.core.decoder import ViterbiDecoder
    from repro_torch.obs import profile

    kw = dict({"use_kernel": True}, **decoder_kw)
    dec = ViterbiDecoder.from_standard(name, device="cpu", **kw)
    rdec = RefDecoder.from_standard(name, **kw)
    assert (dec.decision_depth, dec.ring_packed) == (
        rdec.decision_depth, rdec.ring_packed)
    h100 = _ref_h100()
    for f, t in ((1, 64), (16, 1024), (64, 4096), (3, 250), (512, 65536)):
        for path in PROFILE_PATHS:
            got = profile.dispatch_profile(dec, path, f, t)
            want = ref_profile.dispatch_profile(rdec, path, f, t)
            assert (got.path, got.f_cell, got.n_stages, got.hbm_bytes,
                    got.flops, got.depth) == (
                want.path, want.f_cell, want.n_stages, want.hbm_bytes,
                want.flops, want.depth), (path, f, t)
            priced = ref_profile.dispatch_profile(rdec, path, f, t, hw=h100)
            assert got.span_attrs() == priced.span_attrs()
            assert got.achieved(1e-3, 2) == priced.achieved(1e-3, 2)
            assert got.achieved(0.0) == {} == priced.achieved(0.0)


def _engine_run(recorder):
    from repro_torch.serve import DecodeRequest, make_decode_engine

    engine = make_decode_engine(device="cpu", max_batch=8, recorder=recorder)
    tickets = [engine.submit(req, now=0.0) for req, _ in _requests(5)]
    tickets += [engine.submit(DecodeRequest(
        llrs=_llrs("ccsds-k7", 300, 90 + i, mu=2.0), code="ccsds-k7",
        slo="latency"), now=0.0) for i in range(2)]
    sid = engine.open_session("ccsds-k7", now=0.0)
    for i in range(3):
        tickets.append(engine.submit_chunk(
            sid, _llrs("ccsds-k7", 256, 70 + i, flushed=False), now=0.0))
        engine.drain(now=0.1 * (i + 1))
    engine.drain(now=1.0)
    return engine, tickets


def test_engine_dispatch_spans_carry_the_profile():
    """With the recorder on, every dispatch span (batch routes and the
    session dispatch) carries the modelled attributes of its route and
    cell and the achieved fractions of its wall; the bits are identical
    with the recorder off."""
    from repro_torch.obs import NullRecorder, SpanRecorder, dispatch_profile

    off_engine, off = _engine_run(NullRecorder())
    rec = SpanRecorder()
    engine, on = _engine_run(rec)
    assert len(on) == len(off) and all(t.done for t in on)
    for a, b in zip(on, off, strict=True):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(a.bits, b.bits)
    spans = rec.find("engine.dispatch")
    paths = {s.attrs["path"] for s in spans}
    assert {"session", "wava"} <= paths and len(paths) >= 3
    for s in spans:
        a = s.attrs
        dec = engine._decoder(a["code"])
        n_stages = a["t"]
        if dec.puncture is not None and a["path"] != "session":
            n_stages = dec.puncture.stages_for(a["t"])
        want = dispatch_profile(dec, a["path"], a["f"], n_stages).span_attrs()
        assert {k: a[k] for k in want} == want
        assert a["hw"] == "h100-sxm5-80gb-700w"
        assert a["achieved_hbm_frac"] > 0 and a["wall_s"] > 0
    assert not any("hbm_bytes_modeled" in s.attrs
                   for s in off_engine.recorder.find("engine.dispatch"))


def test_parity_main_on_the_cpu(capsys):
    from repro_torch.kernels import parity

    assert parity.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("✓") == 4
    assert "one K3 and one K1 over 32 steps" in out
