"""Sharded decode: ``repro_torch.distributed.decoder`` against
``repro.distributed.decoder`` and the reference's ``decode_batch``.

The port's ``FrameMesh`` puts logical shards on one CPU device; each
shard runs the single-device program on its own frames, streams or time
span.  The reference's multi-device runs need
``--xla_force_host_platform_device_count`` set before JAX starts, so
they run in one subprocess (4 host devices), which decodes the same
numpy inputs through the reference's ``sharded_decode_frames``,
``sharded_decode_streams`` and ``sharded_decode_time_parallel``,
re-plans its mesh, and replays an engine trace under a chaos schedule
that fails its devices one by one; the port's results must equal what it
writes back.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._torch_serving import _llrs

REPO = Path(__file__).resolve().parent.parent

# the reference's side, in a process of its own with 4 host devices
REF_PROG = r"""
import json, sys
import numpy as np
import jax.numpy as jnp
from repro.core.trellis import CodeSpec
from repro.core.viterbi import TiledDecoderConfig
from repro.distributed.decoder import (
    engine_dispatch_ready, frame_mesh, replan_mesh, sharded_decode_frames,
    sharded_decode_streams, sharded_decode_time_parallel)
from repro.runtime.chaos import ChaosInjector, ChaosSchedule
from repro.serve.engine import DecodeEngine, DecodeRequest

out_dir = sys.argv[1]
data = np.load(out_dir + "/in.npz")
mesh = frame_mesh()
assert mesh.devices.size == 4
res = {"ids": [int(d.id) for d in mesh.devices.reshape(-1)]}
spec = CodeSpec(k=7, polys=(0o171, 0o133))
bits = {}
for fin in (None, 0):
    bits[f"frames_{fin}"] = np.asarray(sharded_decode_frames(
        jnp.asarray(data["frames"]), spec, rho=2, mesh=mesh,
        initial_state=0, final_state=fin))
for op in (False, True):
    bits[f"streams_{op}"] = np.asarray(sharded_decode_streams(
        jnp.asarray(data["streams"]), spec, TiledDecoderConfig(), mesh=mesh,
        use_kernel=op, one_pass=op))
tmesh = frame_mesh(axis="tiles")
for kind in ("awgn", "int"):
    for fin in (None, 0):
        bits[f"tp_{kind}_{fin}"] = np.asarray(sharded_decode_time_parallel(
            jnp.asarray(data[f"tp_{kind}"]), spec, mesh=tmesh, initial_state=0,
            final_state=fin, transfer_tile=16))
res["replan"] = {}
for failed in ([], [3], [1, 3], [0, 1, 2], [0, 1, 2, 3]):
    m = replan_mesh(mesh, failed)
    res["replan"][str(failed)] = None if m is None else [
        int(d.id) for d in m.devices.reshape(-1)]
res["ready"] = [engine_dispatch_ready(f, mesh) for f in range(9)]
eng = DecodeEngine(max_batch=4, use_kernel=False, mesh=mesh, retry=2,
                   chaos=ChaosInjector(ChaosSchedule.from_file(out_dir + "/chaos.json")))
reqs = json.loads(open(out_dir + "/reqs.json").read())
tickets = []
for i, (n, flushed) in enumerate(reqs):
    tickets.append(eng.submit(DecodeRequest(
        llrs=data[f"req{i}"], flushed=flushed), now=0.0))
eng.drain(now=0.0)
res["tickets"] = [dict(id=t.id, path=t.path, error=t.error, retries=t.retries,
                       cell=list(t.cell)) for t in tickets]
for i, t in enumerate(tickets):
    bits[f"ticket{i}"] = t.bits
res["stats"] = eng.stats()
res["mesh_after"] = None if eng.mesh is None else [
    int(d.id) for d in eng.mesh.devices.reshape(-1)]
np.savez(out_dir + "/bits.npz", **bits)
open(out_dir + "/res.json", "w").write(json.dumps(res))
"""

# one flushed cell of 96 stages and four open cells of the 128 rung, of 4
# frames each: every cell fills a mesh of 4, 2 or 1 shards
REQS = [(96, True)] * 4 + [(70 + 3 * i, False) for i in range(16)]


def _chaos():
    """Device failures on the sharded route, one cell each: 4 -> 2
    shards (device 3), a timeout retried, -> 1 shard (device 1), -> none
    (device 0): that cell degrades to batch, and the last cell, with no
    mesh left, is routed to batch."""
    from repro_torch.runtime.chaos import ChaosSchedule, FaultEvent

    return ChaosSchedule([
        FaultEvent(at=0, kind="device_failure", device=3, path="sharded"),
        FaultEvent(at=2, kind="timeout", path="sharded"),
        FaultEvent(at=4, kind="device_failure", device=1, path="sharded"),
        FaultEvent(at=6, kind="device_failure", device=0, path="sharded"),
    ])


def _frames():
    rng = np.random.default_rng(17)
    return np.round(4 * rng.normal(0.5, 1.0, (5, 64, 2))).astype(np.float32)


def _streams():
    """Seven unflushed ccsds-k7 streams of 300 stages (integer LLRs): 7
    does not divide 2 or 4 shards."""
    return np.stack([_llrs("ccsds-k7", 300, 900 + i, flushed=False)
                     for i in range(7)])


def _tp_llrs():
    """Three zero-terminated ccsds-k7 codewords of 512 stages, AWGN LLRs
    at LLR mean 1.6 and their integer copy: 256 steps, 64 a shard."""
    awgn = np.stack([_llrs("ccsds-k7", 512, 950 + i, mu=1.6) for i in range(3)])
    return {"tp_awgn": awgn.astype(np.float32),
            "tp_int": np.round(awgn).astype(np.float32)}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref4")
    arrays = {"frames": _frames(), "streams": _streams(), **_tp_llrs()}
    for i, (n, flushed) in enumerate(REQS):
        arrays[f"req{i}"] = _llrs("ccsds-k7", n, 400 + i, flushed=flushed)
    np.savez(out / "in.npz", **arrays)
    (out / "reqs.json").write_text(json.dumps(REQS))
    (out / "chaos.json").write_text(json.dumps(_chaos().to_json()))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", REF_PROG, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return (json.loads((out / "res.json").read_text()),
            dict(np.load(out / "bits.npz")), arrays)


def _decoder():
    from repro_torch.core import ViterbiDecoder

    return ViterbiDecoder.from_standard("ccsds-k7", use_kernel=False, device="cpu")


@pytest.mark.parametrize("fin", [None, 0])
@pytest.mark.parametrize("shards", [1, 3, 4])
def test_sharded_frames_equal_the_reference_decode_batch(shards, fin):
    import jax.numpy as jnp
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    from repro_torch.distributed import frame_mesh, sharded_decode_frames

    llrs = _frames()
    ref = RefDecoder.from_standard("ccsds-k7", use_kernel=False)
    want = np.asarray(ref.decode_batch(jnp.asarray(llrs), initial_state=0,
                                       final_state=fin, time_parallel=False))
    mesh = frame_mesh(shards, device="cpu")
    dec = _decoder()
    for use_kernel in (False, True):
        got = sharded_decode_frames(
            torch.from_numpy(llrs), dec.spec, rho=2, mesh=mesh, initial_state=0,
            final_state=fin, use_kernel=use_kernel)
        assert got.dtype == torch.int32 and got.shape == (5, 64)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dec.decode_sharded(llrs, mesh=mesh, final_state=fin).numpy(), want)


def test_four_device_reference_run_agrees(reference_run):
    """The reference's ``sharded_decode_frames`` on 4 host devices, its
    re-planning and its dispatch rule, against the port on 4 logical
    shards."""
    from repro_torch.distributed import (
        engine_dispatch_ready,
        frame_mesh,
        replan_mesh,
        sharded_decode_frames,
    )

    res, bits, arrays = reference_run
    mesh = frame_mesh(4, device="cpu")
    assert list(mesh.ids) == res["ids"] == [0, 1, 2, 3]
    dec = _decoder()
    for fin in (None, 0):
        got = sharded_decode_frames(torch.from_numpy(arrays["frames"]), dec.spec,
                                    mesh=mesh, final_state=fin)
        np.testing.assert_array_equal(got.numpy(), bits[f"frames_{fin}"])
    for failed, ids in res["replan"].items():
        m = replan_mesh(mesh, json.loads(failed))
        assert (None if m is None else list(m.ids)) == ids
    assert [engine_dispatch_ready(f, mesh) for f in range(9)] == res["ready"]


def test_engine_failover_equals_the_four_device_reference(reference_run):
    """The same trace and chaos schedule on a 4-shard mesh: failover
    re-plans 4 -> 2 -> 1 shards, then the sharded cells degrade to batch;
    every ticket and ``stats()`` equal the reference's on 4 devices."""
    from repro_torch.distributed import frame_mesh
    from repro_torch.runtime.chaos import ChaosInjector
    from repro_torch.serve import DecodeRequest, make_decode_engine

    res, bits, arrays = reference_run
    eng = make_decode_engine(device="cpu", max_batch=4, use_kernel=False,
                             mesh=frame_mesh(4, device="cpu"), retry=2,
                             chaos=ChaosInjector(_chaos()))
    tickets = [eng.submit(DecodeRequest(llrs=arrays[f"req{i}"], flushed=fl), now=0.0)
               for i, (_, fl) in enumerate(REQS)]
    eng.drain(now=0.0)
    for i, (t, want) in enumerate(zip(tickets, res["tickets"])):
        assert dict(id=t.id, path=t.path, error=t.error, retries=t.retries,
                    cell=list(t.cell)) == want
        np.testing.assert_array_equal(t.bits, bits[f"ticket{i}"])
    s = eng.stats()
    assert json.loads(json.dumps(s)) == res["stats"]
    assert eng.mesh is None and res["mesh_after"] is None
    assert s["failovers"] == 3 and s["degraded"] == 1 and s["retries"] == 3
    assert [t.path for t in tickets[::4]] == ["sharded"] * 3 + ["batch"] * 2


def test_frame_mesh_and_dispatch_rule():
    from repro_torch.distributed import (
        FrameMesh,
        engine_dispatch_ready,
        frame_mesh,
        replan_mesh,
    )

    mesh = frame_mesh(8, axis="frames", device="cpu")
    assert mesh.shape == {"frames": 8} and mesh.size == 8
    assert mesh.ids == tuple(range(8)) and mesh.axis_names == ("frames",)
    assert set(mesh.devices) == {torch.device("cpu")}
    assert frame_mesh(device="cpu").size == 1
    assert [engine_dispatch_ready(f, mesh) for f in (4, 8, 12, 16)] == [
        False, True, False, True]
    # 5 survive -> the power-of-two prefix of 4, in mesh order
    assert replan_mesh(mesh, {1, 4, 6}).ids == (0, 2, 3, 5)
    assert replan_mesh(frame_mesh(1, device="cpu"), {0}) is None
    with pytest.raises(ValueError):
        FrameMesh((torch.device("cpu"),), (0, 1))
    with pytest.raises(ValueError):
        frame_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            frame_mesh()


def test_decode_sharded_depunctures_and_refuses_tail_biting():
    import jax.numpy as jnp
    from repro.core.decoder import ViterbiDecoder as RefDecoder

    from repro_torch.core import ViterbiDecoder
    from repro_torch.distributed import frame_mesh

    llr = np.stack([_llrs("wifi-11a-r34", 120, s) for s in range(3)])
    dec = ViterbiDecoder.from_standard("wifi-11a-r34", use_kernel=False,
                                       device="cpu")
    ref = RefDecoder.from_standard("wifi-11a-r34", use_kernel=False)
    got = dec.decode_sharded(llr, mesh=frame_mesh(2, device="cpu"))
    want = ref.decode_sharded(jnp.asarray(llr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tb = ViterbiDecoder.from_standard("lte-tbcc", device="cpu")
    with pytest.raises(NotImplementedError, match="tail-biting"):
        tb.decode_sharded(np.zeros((2, 40, 3), np.float32))


@pytest.mark.parametrize("one_pass", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_streams_equal_the_four_device_reference(reference_run, shards,
                                                         one_pass):
    """``sharded_decode_streams`` on 1, 2 and 4 shards (7 streams: padded
    on 2 and 4) against the reference's on 4 devices, the one-pass
    windows (K2) and the two-pass ones (K1); each equals the one-device
    fold."""
    from repro_torch.core.trellis import CodeSpec
    from repro_torch.core.viterbi import TiledDecoderConfig, tiled_decode_streams
    from repro_torch.distributed import frame_mesh, sharded_decode_streams

    _, bits, arrays = reference_run
    spec = CodeSpec(k=7, polys=(0o171, 0o133))
    x = torch.from_numpy(arrays["streams"])
    got = sharded_decode_streams(x, spec, TiledDecoderConfig(),
                                 mesh=frame_mesh(shards, device="cpu"),
                                 one_pass=one_pass)
    assert got.dtype == torch.int32 and got.shape == (7, 300)
    np.testing.assert_array_equal(got.numpy(), bits[f"streams_{one_pass}"])
    np.testing.assert_array_equal(got.numpy(), tiled_decode_streams(
        x, spec, one_pass=one_pass, device="cpu").numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("fin", [None, 0])
@pytest.mark.parametrize("kind", ["awgn", "int"])
def test_time_sharded_equals_the_four_device_reference(reference_run, kind, fin,
                                                       use_kernel):
    """``sharded_decode_time_parallel`` on 4 shards against the
    reference's own on 4 devices, bit for bit (the span products folded
    in the reference's order), free and pinned end states, AWGN and
    integer LLRs, K3/K1's plain versions and the plain scans."""
    from repro_torch.core.trellis import CodeSpec
    from repro_torch.distributed import frame_mesh, sharded_decode_time_parallel

    _, bits, arrays = reference_run
    spec = CodeSpec(k=7, polys=(0o171, 0o133))
    got = sharded_decode_time_parallel(
        torch.from_numpy(arrays[f"tp_{kind}"]), spec,
        mesh=frame_mesh(4, axis="tiles", device="cpu"), initial_state=0,
        final_state=fin, transfer_tile=16, use_kernel=use_kernel)
    assert got.dtype == torch.int32 and got.shape == (3, 512)
    np.testing.assert_array_equal(got.numpy(), bits[f"tp_{kind}_{fin}"])


def test_time_sharded_shapes_and_refusals():
    """One shard is the one-device time-parallel decode; a step count
    that does not divide the shards raises, as in the reference; the
    transfer tile is picked on each shard's span."""
    from repro_torch.core import CODE_K7_CCSDS
    from repro_torch.core.timeparallel import decode_time_parallel
    from repro_torch.distributed import frame_mesh, sharded_decode_time_parallel

    x = torch.from_numpy(_frames())  # 64 stages = 32 steps
    mesh = {n: frame_mesh(n, axis="tiles", device="cpu") for n in (1, 3, 4)}
    one = sharded_decode_time_parallel(
        x, CODE_K7_CCSDS, mesh=mesh[1], initial_state=0, transfer_tile=8)
    np.testing.assert_array_equal(one.numpy(), decode_time_parallel(
        x, CODE_K7_CCSDS, initial_state=0, final_state=None, transfer_tile=8,
        device="cpu").numpy())
    with pytest.raises(ValueError, match="not divisible by 3 devices"):
        sharded_decode_time_parallel(x, CODE_K7_CCSDS, mesh=mesh[3])
    with pytest.raises(ValueError, match="divisible by rho"):
        sharded_decode_time_parallel(x[:, :63], CODE_K7_CCSDS, mesh=mesh[1])
    # 32 steps over 4 shards: 8 a shard, tile 3 -> the largest divisor, 2
    four = sharded_decode_time_parallel(
        x, CODE_K7_CCSDS, mesh=mesh[4], initial_state=0, transfer_tile=3)
    assert four.shape == (5, 64)
