"""The verification slice: ``repro_torch.verify.farm`` and
``repro_torch.verify.gate`` against the reference's ``repro.verify``.

The gate is pure logic on ``core.ber.estimate_ber`` and must give the
reference's verdicts and reasons on the same counts.  The farm's noise is
a ``torch.Generator``'s, not ``jax.random``'s, so it is held three ways:
each path's ``decode_fn`` to the reference's on the same numpy LLRs, bit
for bit; the farm's counts to the port's own direct decodes of the same
batches, and across logical shards; and the two farms' error rates to
each other by confidence-interval overlap, through both packages' gates
(frame error rates: see ``test_smoke_grid_error_rates_pass_each_others_gate``).
"""
import json
import types

import numpy as np
import pytest
import torch

from _torch_serving import _llrs

FARM_CODES = ["ccsds-k7", "wifi-11a-r34", "lte-tbcc", "gsm-cs1"]
PATHS = ("reference", "kernel", "time_parallel", "engine", "sharded")


def _pair_points(counts, code="ccsds-k7", bits=100_000, frames=100):
    """The same (path, ebn0, errors) counts as FarmPoints of both
    packages."""
    from repro.verify.farm import FarmPoint as RefPoint

    from repro_torch.verify.farm import FarmPoint

    ours, ref = [], []
    for path, ebn0, errors in counts:
        kw = dict(code=code, path=path, ebn0_db=ebn0, n_frames=frames,
                  frame_bits=bits // frames, n_bits=bits, bit_errors=errors,
                  frame_errors=min(errors, frames))
        ours.append(FarmPoint(**kw))
        ref.append(RefPoint(**kw))
    return ours, ref


GATE_CASES = {
    "exact": [("reference", 3.0, 123), ("kernel", 3.0, 123)],
    "overlap": [("reference", 3.0, 100), ("kernel", 3.0, 110)],
    "disjoint": [("reference", 3.0, 100), ("kernel", 3.0, 300)],
    "zero_errors": [("reference", 6.0, 0), ("engine", 6.0, 0),
                    ("kernel", 6.0, 3)],
    "missing_reference": [("reference", 3.0, 50), ("kernel", 3.0, 50),
                          ("kernel", 5.0, 50)],
    "several_paths": [("reference", 2.0, 900), ("kernel", 2.0, 1000),
                      ("time_parallel", 2.0, 900), ("engine", 2.0, 700),
                      ("reference", 4.0, 10), ("sharded", 4.0, 40)],
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
@pytest.mark.parametrize("confidence", [None, 0.95])
def test_gate_verdicts_equal_reference(case, confidence):
    from repro.verify import gate as ref_gate

    from repro_torch.verify import gate

    ours, ref = _pair_points(GATE_CASES[case])
    got = gate.run_gate(ours, confidence=confidence)
    want = ref_gate.run_gate(ref, confidence=confidence)
    assert [(v.code, v.path, v.ebn0_db, v.passed, v.reason, v.label)
            for v in got] == [(v.code, v.path, v.ebn0_db, v.passed, v.reason,
                               v.label) for v in want]
    assert gate.all_pass(got) == ref_gate.all_pass(want)
    if case == "missing_reference":
        assert not gate.all_pass(got)
        assert "no 'reference'" in got[-1].reason


def test_gate_cell_mismatch_raises_as_the_reference():
    from repro.verify import gate as ref_gate

    from repro_torch.verify import gate

    ours, ref = _pair_points([("reference", 3.0, 10), ("kernel", 4.0, 10)])
    with pytest.raises(ValueError, match="share a grid cell"):
        gate.gate_point(*ours)
    with pytest.raises(ValueError, match="share a grid cell"):
        ref_gate.gate_point(*ref)


@pytest.mark.parametrize("budget", [8, 64, 255, 256, 1024])
def test_message_bits_equal_reference(budget):
    from repro.codes.registry import get_code as ref_code
    from repro.verify.farm import _message_bits as ref_bits

    from repro_torch.codes import REGISTRY, get_code
    from repro_torch.verify.farm import _message_bits

    for name in sorted(REGISTRY):
        try:
            want = ref_bits(ref_code(name), budget)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc).split("=")[0]):
                _message_bits(get_code(name), budget)
            continue
        assert _message_bits(get_code(name), budget) == want


@pytest.mark.parametrize("frames,batch,shards,chunk", [
    (1024, 32, 1, 4096), (32, 16, 1, 4096), (40, 16, 2, 4096),
    (100, 8, 3, 5), (1, 16, 4, 3), (4096, 16, 1, 4096)])
def test_farm_rounding_equals_reference(frames, batch, shards, chunk):
    """``n_batches`` and ``scan_chunk`` round up to whole batches and whole
    shard counts as in the reference, so ``FarmPoint.n_frames`` is the
    reference's for the same arguments."""
    from repro.verify.farm import BerFarm as RefFarm

    from repro_torch.distributed.decoder import frame_mesh
    from repro_torch.verify.farm import BerFarm

    mesh = None if shards == 1 else frame_mesh(shards, device="cpu")
    ref_mesh = None if shards == 1 else types.SimpleNamespace(
        shape={"shards": shards})
    ours = BerFarm(["ccsds-k7"], [4.0], frames_per_point=frames,
                   batch_frames=batch, mesh=mesh, scan_chunk=chunk,
                   device="cpu")
    ref = RefFarm(["ccsds-k7"], [4.0], frames_per_point=frames,
                  batch_frames=batch, mesh=ref_mesh, scan_chunk=chunk)
    assert (ours.n_batches, ours.scan_chunk) == (ref.n_batches, ref.scan_chunk)
    pt = ours.run_point("ccsds-k7", 8.0, "reference") if frames <= 64 else None
    if pt is not None:
        assert pt.n_frames == ref.n_batches * ref.batch_frames
        assert pt.n_bits == pt.n_frames * pt.frame_bits


def _farm_llrs(name, seed):
    """Two integer-LLR frames and two AWGN-LLR frames of the farm's
    256-stage budget, as one numpy batch."""
    from repro_torch.codes import get_code
    from repro_torch.verify.farm import _message_bits

    n = 256 if get_code(name).termination == "tailbiting" else (
        _message_bits(get_code(name), 256) + get_code(name).spec.k - 1)
    frames = [_llrs(name, n, seed + i) for i in range(2)]
    frames += [_llrs(name, n, seed + 2 + i, mu=1.5) for i in range(2)]
    return np.stack(frames)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", FARM_CODES)
def test_decode_fn_bits_equal_reference(name, path):
    """Every farm path's ``decode_fn`` returns the reference's bits on the
    same numpy LLRs (integer and AWGN frames in one batch); the sharded
    path refuses tail-biting codes in both packages."""
    import jax.numpy as jnp
    from repro.verify.farm import BerFarm as RefFarm

    from repro_torch.verify.farm import BerFarm

    ours = BerFarm([name], [4.0], paths=(path,), batch_frames=4, device="cpu")
    ref = RefFarm([name], [4.0], paths=(path,), batch_frames=4)
    if name == "lte-tbcc" and path == "sharded":
        with pytest.raises(ValueError, match="tail-biting"):
            ours.decode_fn(name, path)
        with pytest.raises(ValueError, match="tail-biting"):
            ref.decode_fn(name, path)
        return
    llrs = _farm_llrs(name, 100)
    got = ours.decode_fn(name, path)(torch.from_numpy(llrs))
    want = np.asarray(ref.decode_fn(name, path)(jnp.asarray(llrs)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_farm_counts_equal_direct_decodes():
    """A point's counts are the port's own decodes of the same seeded
    batches, counted by hand."""
    from repro_torch.codes import get_code
    from repro_torch.codes.simulate import batch_keys, sim_frame_batch
    from repro_torch.core.decoder import ViterbiDecoder
    from repro_torch.verify.farm import BerFarm

    farm = BerFarm(["wifi-11a-r34"], [2.0], paths=("kernel",),
                   frames_per_point=24, batch_frames=8, seed=3,
                   scan_chunk=2, device="cpu")
    pt = farm.run_point("wifi-11a-r34", 2.0, "kernel")
    dec = ViterbiDecoder.from_standard("wifi-11a-r34", decision_depth=512,
                                       device="cpu")
    be = fe = 0
    for key in batch_keys(3, "wifi-11a-r34", 2.0, 3):
        gen = torch.Generator().manual_seed(key)
        bits, llrs = sim_frame_batch(gen, get_code("wifi-11a-r34"), 8, 250, 2.0)
        err = dec.decode_stream_chunked(llrs, initial_state=0, final_state=0)[
            :, :250] != bits
        be += int(err.sum())
        fe += int(err.any(dim=1).sum())
    assert (pt.n_frames, pt.frame_bits, pt.bit_errors, pt.frame_errors) == (
        24, 250, be, fe)
    assert be > 0


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_counts_equal_single_device(shards):
    """The mesh paths split their seeds over logical CPU shards; the
    counts equal the single-device counts exactly."""
    from repro_torch.distributed.decoder import frame_mesh
    from repro_torch.verify.farm import BerFarm

    kw = dict(codes=["ccsds-k7", "lte-tbcc"], ebn0_dbs=[1.0, 3.0],
              paths=("reference", "time_parallel"),
              frames_per_point=shards * 8, batch_frames=4, seed=9,
              scan_chunk=shards, device="cpu")
    single = BerFarm(**kw).run()
    sharded = BerFarm(mesh=frame_mesh(shards, device="cpu"), **kw).run()
    assert single == sharded  # FarmPoint equality ignores the seconds
    assert any(p.bit_errors for p in single)


def test_farm_engine_path_bit_exact_via_flushed():
    """The engine decodes farm frames (declared flushed) to the counts
    of the pinned reference decode, on a punctured rate."""
    from repro_torch.verify import BerFarm, all_pass, run_gate

    farm = BerFarm(codes=["wifi-11a-r34"], ebn0_dbs=[3.0],
                   paths=("reference", "engine"), frames_per_point=16,
                   batch_frames=16, seed=2, device="cpu")
    ref, eng = farm.run()
    assert (ref.bit_errors, ref.frame_errors) == (eng.bit_errors, eng.frame_errors)
    assert ref.bit_errors > 0
    assert all_pass(run_gate([ref, eng]))


def _as_frame_trials(points, point_cls, path):
    """The points' frame counts as independent trials: one "bit" a
    frame, its error a frame error."""
    return [point_cls(code=p.code, path=path, ebn0_db=p.ebn0_db,
                      n_frames=p.n_frames, frame_bits=1, n_bits=p.n_frames,
                      bit_errors=p.frame_errors, frame_errors=p.frame_errors)
            for p in points]


def test_smoke_grid_error_rates_pass_each_others_gate():
    """The smoke grid (ccsds-k7 and wifi-11a-r34 at 2, 4 and 6 dB, 32
    frames a point) in both packages, each from seed 0: the port's error
    rate passes the reference's gate against the reference's, and the
    reference's passes the port's gate against the port's.  Both noise
    streams are seeded, so the outcome is fixed.

    The rates compared are frame error rates: frames are independent
    trials, which the gate's Clopper-Pearson intervals assume.  Bit
    errors are not: a Viterbi error event flips a burst of bits, so at
    matched BER two unmatched noise draws fall outside each other's bit
    intervals far more often than the confidence says (ROADMAP queue 3,
    R9: between two seeds of the reference itself, 15% of ccsds-k7 and
    56% of wifi-11a-r34 pairs at 2 dB).  Both packages' bit counts are
    printed; the gate's bit-level test stays for matched noise, where
    identical counts pass exactly."""
    from repro.verify import farm as ref_farm
    from repro.verify import gate as ref_gate

    from repro_torch.verify import farm, gate

    grid = dict(codes=["ccsds-k7", "wifi-11a-r34"], ebn0_dbs=[2.0, 4.0, 6.0],
                paths=("reference",), frames_per_point=32, batch_frames=16)
    ours = farm.BerFarm(device="cpu", **grid).run()
    ref = ref_farm.BerFarm(**grid).run()
    for a, b in zip(ours, ref, strict=True):
        assert (a.code, a.ebn0_db, a.n_bits) == (b.code, b.ebn0_db, b.n_bits)
        print(f"{a.code}@{a.ebn0_db:g}: port {a.bit_errors} bits / "
              f"{a.frame_errors} frames, reference {b.bit_errors} / "
              f"{b.frame_errors} of {a.n_bits} / {a.n_frames}")
    by_ref = ref_gate.run_gate(
        _as_frame_trials(ref, ref_farm.FarmPoint, "reference")
        + _as_frame_trials(ours, ref_farm.FarmPoint, "port"))
    by_port = gate.run_gate(
        _as_frame_trials(ours, farm.FarmPoint, "reference")
        + _as_frame_trials(ref, farm.FarmPoint, "jax"))
    assert len(by_ref) == len(by_port) == 6
    for v in by_ref + by_port:
        assert v.passed, (v.label, v.reason)
    # the waterfall is in the grid: frame errors at 2 dB in both packages
    assert all(p.frame_errors > 0 for p in ours + list(ref) if p.ebn0_db == 2.0)


def test_farm_to_json_schema_equals_reference():
    from repro.verify import farm as ref_farm
    from repro.verify import gate as ref_gate

    from repro_torch.verify import farm, gate

    ours, ref = _pair_points(GATE_CASES["several_paths"])
    got = farm.farm_to_json(ours, gate.run_gate(ours))
    want = ref_farm.farm_to_json(ref, ref_gate.run_gate(ref))
    assert got.keys() == want.keys()
    assert got["all_pass"] == want["all_pass"] and got["gate"] == want["gate"]
    for a, b in zip(got["points"], want["points"], strict=True):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=0)
            else:
                assert a[k] == b[k], k
    assert farm._point_row(ours[0]) == ref_farm._point_row(ref[0])


def test_main_on_the_cpu(tmp_path, capsys):
    """``main(["--device", "cpu", ...])`` runs every path, passes its gate,
    writes the JSON artifact and the progress spans, and exits 0."""
    from repro_torch.verify import farm

    out, trace = tmp_path / "farm.json", tmp_path / "obs" / "farm.jsonl"
    rc = farm.main(["--device", "cpu", "--codes", "ccsds-k7", "--ebn0", "3",
                    "--paths", ",".join(PATHS), "--frames", "16",
                    "--out", str(out), "--progress", "--trace-out", str(trace)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "ber-gate: 4/4 pass" in text and "16 frames/point on cpu" in text
    blob = json.loads(out.read_text())
    assert blob["all_pass"] and len(blob["points"]) == 5
    assert len({(p["bit_errors"], p["frame_errors"]) for p in blob["points"]}) == 1
    spans = [json.loads(line) for line in trace.read_text().splitlines()]
    points = [s for s in spans if s.get("name") == "farm.point"]
    assert len(points) == 5
    assert all(any(e["name"] == "farm.progress" for e in s["events"])
               for s in points)


def test_farm_entry_points_refuse_without_the_card():
    """With no ``--device`` the farm and the parity main decode on the
    card; where there is none they raise instead of running on the
    CPU."""
    from repro_torch.kernels import parity
    from repro_torch.verify import farm

    if torch.cuda.is_available():
        assert farm.BerFarm(["ccsds-k7"], [4.0]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        farm.BerFarm(["ccsds-k7"], [4.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        farm.main(["--frames", "16"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main([])
