"""The serving launcher: ``repro_torch.serve.step``'s Viterbi factories and
``repro_torch.launch.serve`` against ``repro.serve.step`` and
``repro.launch.serve`` on the same numpy-seeded integer LLRs.

Both sides take the same path: the reference's two-pass step
(``use_kernel=False``) against the port's K1 plain version
(``one_pass=False``), and the reference's one-pass windows (K2 in
interpret mode) against the port's K2 plain version.  The bits are held
exactly.  The launcher's tiled mode must fold every stream's windows
into one window decode: the wrappers are counted where ``kernels/ops.py``
calls them (on the CPU their plain versions run and no launch counter
moves).
"""
import argparse
import json

import numpy as np
import pytest
import torch

from tests._torch_serving import _llrs

N_STREAMS, N_STAGES = 3, 300  # 300 stages: 5 windows of 64, the last ragged


def _streams(code, seed, n=N_STAGES, count=N_STREAMS):
    """``count`` unflushed streams of ``code`` (integer LLRs): (N, n, beta),
    or the serial kept streams (N, Lp) of a punctured code."""
    return np.stack([_llrs(code, n, seed + i, flushed=False) for i in range(count)])


def _configs(which):
    from repro.configs import viterbi_k7 as ref

    from repro_torch.configs import viterbi_k7 as ours

    if which == "smoke":
        return ours.smoke_config(), ref.smoke_config()
    if which in ("CONFIG", "CONFIG_OPTIMIZED"):
        return getattr(ours, which), getattr(ref, which)
    return ours.config_for_standard(which), ref.config_for_standard(which)


STEP_CASES = [
    ("CONFIG", "tiled", False), ("CONFIG", "tiled", True),
    ("smoke", "tiled", False), ("smoke", "tiled", True),
    ("CONFIG_OPTIMIZED", "tiled", True),
    ("wifi-11a-r34", "tiled", False), ("wifi-11a-r34", "tiled", True),
    ("CONFIG", "batch", False), ("wifi-11a-r34", "batch", False),
    ("lte-tbcc", "batch", False),
]


@pytest.mark.parametrize("which,mode,one_pass", STEP_CASES)
def test_serve_step_equals_the_reference(which, mode, one_pass):
    import jax
    import jax.numpy as jnp
    from repro.serve.step import make_viterbi_serve_step as ref_step

    from repro_torch.serve.step import make_viterbi_serve_step

    ours, ref = _configs(which)
    n = 40 if ours.code == "lte-tbcc" else N_STAGES
    x = _streams(ours.code, 50, n=n)
    want = np.asarray(jax.jit(ref_step(ref, use_kernel=one_pass, mode=mode))(
        jnp.asarray(x)))
    step = make_viterbi_serve_step(ours, mode=mode, one_pass=one_pass, device="cpu")
    got = step(x)
    assert got.dtype == torch.int32 and got.shape == want.shape == (N_STREAMS, n)
    np.testing.assert_array_equal(got.numpy(), want)


class _Calls:
    """Counts the kernel wrappers' calls where ``kernels/ops.py`` makes
    them."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import ops

        self.n = {"K1": 0, "K2": 0, "K3": 0}
        for label, name in (("K1", "acs_forward"), ("K2", "acs_decode_fused"),
                            ("K3", "transfer_matrix")):
            monkeypatch.setattr(ops, name, self._counted(label, getattr(ops, name)))

    def _counted(self, label, fn):
        def counted(*a, **kw):
            self.n[label] += 1
            return fn(*a, **kw)
        return counted


@pytest.mark.parametrize("code", ["ccsds-k7", "wifi-11a-r34"])
@pytest.mark.parametrize("one_pass", [True, False])
def test_tiled_step_is_one_launch_for_every_stream(monkeypatch, code, one_pass):
    """N streams decode in ONE window decode: one K2 call with the
    one-pass path, else one K1 call, never one per stream; each stream's
    bits equal ``decode_stream_tiled`` on that stream alone."""
    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.serve.step import make_viterbi_decoder, make_viterbi_serve_step

    cfg = config_for_standard(code)
    x = _streams(code, 70, count=5)
    step = make_viterbi_serve_step(cfg, one_pass=one_pass, device="cpu")
    calls = _Calls(monkeypatch)
    got = step(x)
    assert calls.n == ({"K1": 0, "K2": 1, "K3": 0} if one_pass
                       else {"K1": 1, "K2": 0, "K3": 0})
    dec = make_viterbi_decoder(cfg, one_pass=one_pass, device="cpu")
    tiling = dec.default_tiled_config(cfg.tiled)
    for i in range(5):
        np.testing.assert_array_equal(
            got[i].numpy(), dec.decode_stream_tiled(x[i], tiling).numpy())


def test_serve_step_refusals():
    from repro_torch.configs.viterbi_k7 import CONFIG, config_for_standard
    from repro_torch.serve.step import make_viterbi_serve_step

    with pytest.raises(ValueError, match="mode='batch'"):
        make_viterbi_serve_step(config_for_standard("lte-tbcc"), mode="tiled",
                                device="cpu")
    with pytest.raises(ValueError, match="unknown serve mode"):
        make_viterbi_serve_step(CONFIG, mode="chunked", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_viterbi_serve_step(CONFIG)


RUN_CASES = [("ccsds-k7", m, False) for m in
             ("tiled", "chunked", "sharded", "batch", "time_parallel")] + [
    ("ccsds-k7", "tiled", True), ("ccsds-k7", "sharded", True),
    ("wifi-11a-r34", "chunked", False), ("wifi-11a-r34", "sharded", False),
    ("lte-tbcc", "batch", False),
]


@pytest.mark.parametrize("code,mode,use_kernel", RUN_CASES)
def test_run_fn_modes_equal_the_reference(code, mode, use_kernel):
    """Every ``--mode`` of ``_viterbi_run_fn`` against the reference's on
    the same LLRs (the reference's sharded mode on its one CPU device,
    the port's on one CPU shard)."""
    import jax.numpy as jnp
    from repro.configs.viterbi_k7 import config_for_standard as ref_cfg
    from repro.launch import serve as ref_serve

    from repro_torch.configs.viterbi_k7 import config_for_standard
    from repro_torch.launch import serve

    kw = dict(mode=mode, use_kernel=use_kernel, decision_depth=64, chunk_len=128)
    n = 40 if code == "lte-tbcc" else 256
    x = _streams(code, 90, n=n)
    want = np.asarray(ref_serve._viterbi_run_fn(ref_cfg(code), argparse.Namespace(**kw))(
        jnp.asarray(x)))
    run = serve._viterbi_run_fn(config_for_standard(code),
                                argparse.Namespace(device="cpu", **kw))
    got = run(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_run_fn_path_follows_use_kernel(monkeypatch):
    """``--use-kernel`` picks the path and the decoder keeps its kernels
    either way: chunked takes K2 a chunk with it, K1 a chunk without."""
    from repro_torch.configs.viterbi_k7 import CONFIG
    from repro_torch.launch import serve

    x = _streams("ccsds-k7", 5, n=256, count=2)
    for use_kernel, want in ((True, "K2"), (False, "K1")):
        run = serve._viterbi_run_fn(CONFIG, argparse.Namespace(
            mode="chunked", use_kernel=use_kernel, decision_depth=64,
            chunk_len=128, device="cpu"))
        calls = _Calls(monkeypatch)
        run(torch.from_numpy(x))
        assert calls.n[want] == 2 and sum(calls.n.values()) == 2, calls.n


@pytest.mark.parametrize("argv,tag", [
    (["--mode", "tiled", "--use-kernel"], "viterbi-tiled"),
    (["--mode", "chunked", "--chunk-len", "256"], "viterbi-chunked"),
    (["--mode", "sharded"], "viterbi-sharded"),
    (["--mode", "batch"], "viterbi-batch"),
    (["--mode", "time_parallel"], "viterbi-time_parallel"),
    (["--optimized", "--use-kernel"], "viterbi-tiled-opt"),
    (["--code", "wifi-11a-r34", "--optimized"], "viterbi-tiled-opt"),
    (["--code", "lte-tbcc", "--mode", "tiled"], "viterbi-batch"),
])
def test_main_viterbi_reports_ber_zero_on_clean_llrs(capsys, argv, tag):
    from repro_torch.launch import serve

    rep = serve.main(["--service", "viterbi", "--streams", "2", "--stream-len",
                      "512", "--batches", "2", "--ebn0", "12", "--device", "cpu"]
                     + argv)
    out = capsys.readouterr().out
    assert out.startswith(f"[{tag}] {rep['bits']} bits in ")
    assert "(1 dev), BER=0.000e+00" in out
    assert rep["bits"] == 2 * 2 * 512 and rep["errors"] == 0 and rep["n_dev"] == 1
    bits, llrs, decoded = rep["last"]
    assert torch.equal(decoded, bits)


def _engine_args(tmp_path, extra=()):
    return ["--service", "engine", "--streams", "8", "--stream-len", "1024",
            "--batches", "2", "--ebn0", "12", "--device", "cpu", *extra]


def test_main_engine_report_lines_and_paths(capsys, tmp_path):
    """The engine service prints the reference's three report lines, BER 0
    at 12 dB, and routes its cells as the reference's launcher does
    (lengths and codes alone decide the routes)."""
    from repro.launch import serve as ref_serve

    from repro_torch.launch import serve
    from repro_torch.obs import top

    jsonl = tmp_path / "m.jsonl"
    rep = serve.main(_engine_args(tmp_path, ["--metrics-jsonl", str(jsonl)]))
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[engine]")]
    assert lines[0].startswith(f"[engine] {rep['bits']} bits in ")
    assert lines[0].endswith("BER=0.000e+00") and rep["errors"] == 0
    assert rep["requests"] == 16 and rep["errored"] == rep["dropped"] == 0
    assert lines[1].startswith("[engine] batches=") and "paths=" in lines[1]
    assert lines[2].startswith("[engine] peak_queue=")
    assert lines[-1] == f"[engine] spans+metrics -> {jsonl}"
    assert "# TYPE engine_requests_total counter" in out
    assert top.main(["--jsonl", str(jsonl)]) == 0
    assert capsys.readouterr().out.startswith("requests  submitted=16 completed=16")

    args = serve._parser().parse_args(_engine_args(tmp_path))
    ref_serve.serve_engine(args)
    ref_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[engine]")]
    assert lines[1].split(" paths=")[1] == ref_lines[1].split(" paths=")[1]
    assert lines[1].split()[1] == ref_lines[1].split()[1]  # batches=


def test_main_engine_chaos_checkpoint_scrub(capsys, tmp_path):
    from repro_torch.launch import serve
    from repro_torch.runtime.chaos import ChaosSchedule, FaultEvent

    sched = tmp_path / "chaos.json"
    sched.write_text(json.dumps(ChaosSchedule([
        FaultEvent(at=0, kind="device_failure", device=0),
        FaultEvent(at=2, kind="timeout"),
    ]).to_json()))
    rep = serve.main(_engine_args(tmp_path, [
        "--chaos", str(sched), "--checkpoint-dir", str(tmp_path / "ck"),
        "--scrub-rate", "0.5"]))
    out = capsys.readouterr().out
    s = rep["stats"]
    assert s["faults"] == {"device_failure": 1, "timeout": 1}
    assert s["retries"] == 2 and rep["errored"] == 0 and rep["errors"] == 0
    assert f"[engine] faults={s['faults']} retries=2 " in out
    assert "[engine] scrub rate=0.5 " in out and "false_alarms=0" in out
    assert "[engine] final session checkpoint -> " in out


def test_service_lm_raises():
    """``--service lm`` runs on the CPU when asked (the name predates the
    LM slice); without ``--device`` it means the card, and raises on a
    host without one instead of falling back."""
    from repro_torch.launch import serve

    rep = serve.main(["--service", "lm", "--tokens", "2", "--streams", "2",
                      "--device", "cpu"])
    assert tuple(rep["tokens"].shape) == (2, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--service", "lm", "--tokens", "2", "--streams", "2"])
