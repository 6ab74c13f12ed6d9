"""The port stands alone: no import of ``jax`` or ``repro`` from
``src/repro_torch`` or ``chip_smoke.py``, every module imports on a
CPU-only torch with no ``triton`` and no ``nvcc``, the card is the
default device with no fallback to the CPU, and the entry points of
later slices refuse instead of running something else."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.args[0].value.split(".")[0]


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) >= 20 and (REPO / "chip_smoke.py").is_file()
    bad = {
        str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
        for f in files
    }
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, f"the port imports the reference or JAX: {bad}"


def test_every_module_imports_without_triton_nvcc_or_jax():
    """In a fresh interpreter with ``triton`` blocked and no CUDA
    toolkit on PATH, every module imports and neither JAX nor the
    reference package gets loaded."""
    modules = list(_module_names())
    assert "repro_torch.kernels.viterbi_acs" in modules
    # the serving slice's packages are scanned and imported too
    assert {"repro_torch.serve.engine", "repro_torch.serve.step",
            "repro_torch.runtime.chaos", "repro_torch.runtime.failure",
            "repro_torch.runtime.checkpoint", "repro_torch.verify.scrub",
            "repro_torch.distributed.decoder", "repro_torch.obs.trace"} <= set(modules)
    # and the launcher slice's
    assert {"repro_torch.configs", "repro_torch.configs.viterbi_k7",
            "repro_torch.launch", "repro_torch.launch.serve",
            "repro_torch.obs.top", "repro_torch.obs.smoke",
            "repro_torch.runtime.chaos_smoke",
            "repro_torch.verify.scrub_smoke"} <= set(modules)
    # and the verification and tooling slice's
    assert {"repro_torch.roofline", "repro_torch.kernels.traffic",
            "repro_torch.kernels.parity", "repro_torch.obs.profile",
            "repro_torch.verify.farm", "repro_torch.verify.gate"} <= set(modules)
    # and the LM testbed's serving slice's
    assert {"repro_torch.configs.base", "repro_torch.configs.smollm_135m",
            "repro_torch.configs.mamba2_370m", "repro_torch.models",
            "repro_torch.models.layers", "repro_torch.models.ssd",
            "repro_torch.models.moe", "repro_torch.models.lm"} <= set(modules)
    # and the LM testbed's training slice's
    assert {"repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.train",
            "repro_torch.train.step", "repro_torch.train.loop",
            "repro_torch.launch.train", "repro_torch.data.pipeline"} <= set(modules)
    # and the sharding and HLO-tooling slice's
    assert {"repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.distributed.sharding", "repro_torch.distributed.spmd",
            "repro_torch.distributed.pipeline", "repro_torch.hlocount"} <= set(modules)
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "loaded = sorted(m for m in sys.modules\n"
        "                if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not loaded, loaded\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not (Path(p) / "nvcc").exists()
    )
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def test_default_device_is_the_card_without_fallback():
    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder

    if torch.cuda.is_available():
        assert ViterbiDecoder(CODE_K7_CCSDS).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ViterbiDecoder(CODE_K7_CCSDS)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ViterbiDecoder.from_standard("ccsds-k7", device="cuda")
    assert ViterbiDecoder(CODE_K7_CCSDS, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        ViterbiDecoder(CODE_K7_CCSDS, device="meta")


@pytest.mark.parametrize("builder", ["tropical_identity", "semiring_identity",
                                     "logprob_identity", "init_metric",
                                     "lm_init_params", "lm_init_cache",
                                     "lm_language_model", "lm_rope_freqs",
                                     "train_state", "opt_state_from_numpy",
                                     "token_stream", "train_loop"])
def test_exported_tensor_builders_default_to_the_card(builder):
    """The exported helpers that build a tensor follow the entry points:
    ``device=None`` is the card, and only an explicit ``"cpu"`` is not."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.semiring import LOGPROB, TROPICAL
    from repro_torch.core.timeparallel import tropical_identity
    from repro_torch.core.viterbi import init_metric
    from repro_torch.data import TokenStream
    from repro_torch.models import layers, lm
    from repro_torch.train.loop import TrainLoopConfig, train
    from repro_torch.train.step import init_train_state, opt_state_from_numpy

    cfg = get_smoke_config("smollm-135m")
    zeros = {"w": np.zeros(2, np.float32)}
    build = {
        "tropical_identity": lambda device=None: tropical_identity(4, device),
        "semiring_identity": lambda device=None: TROPICAL.identity(4, device),
        "logprob_identity": lambda device=None: LOGPROB.identity(4, device),
        "init_metric": lambda device=None: init_metric(2, 4, 0, device),
        "lm_init_params": lambda device=None: lm.init_params(cfg, device=device)["embed"],
        "lm_init_cache": lambda device=None: lm.init_cache(cfg, 2, 8, device)["k"],
        "lm_language_model": lambda device=None: lm.LanguageModel.init(
            cfg, device=device).weights["lm_head"],
        "lm_rope_freqs": lambda device=None: layers.rope_freqs(8, 4, device=device)[0],
        "train_state": lambda device=None: init_train_state(
            cfg, device=device)[1].m["embed"],
        "opt_state_from_numpy": lambda device=None: opt_state_from_numpy(
            (np.int32(0), zeros, zeros), device).step,
        "token_stream": lambda device=None: TokenStream(
            vocab_size=8, batch=1, seq_len=4, device=device).batch_at(0)["tokens"],
        "train_loop": lambda device=None: train(
            cfg, TrainLoopConfig(steps=0), device=device)[0]["lm_head"],
    }[builder]
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert build("cpu").device.type == "cpu"


@pytest.mark.parametrize("factory", ["test_mesh", "production_mesh", "multi_pod_mesh"])
def test_meshes_default_to_the_card(factory):
    """A mesh without ``device`` puts its shards on the card and raises
    where there is none; ``"cpu"`` and the dry run's ``"meta"`` are asked
    for by name."""
    from repro_torch.launch import mesh

    build = {
        "test_mesh": lambda device=None: mesh.make_test_mesh((2, 2), device=device),
        "production_mesh": lambda device=None: mesh.make_production_mesh(device=device),
        "multi_pod_mesh": lambda device=None: mesh.make_production_mesh(True, device),
    }[factory]
    if torch.cuda.is_available():
        assert {d.type for d in build().devices} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert {d.type for d in build("cpu").devices} == {"cpu"}
    assert {d.type for d in build("meta").devices} == {"meta"}


def test_launch_train_defaults_to_the_card():
    """``launch.train`` runs on the card unless ``--device cpu``."""
    from repro_torch.launch import train

    argv = ["--smoke", "--steps", "0"]
    if torch.cuda.is_available():
        assert train.main(argv) == []
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(argv)
    assert train.main(argv + ["--device", "cpu"]) == []


def test_later_slices_refuse():
    from repro_torch.core import CODE_K7_CCSDS, ViterbiDecoder
    from repro_torch.core.semiring import Semiring
    from repro_torch.kernels import acs_decode_fused, acs_forward, viterbi_forward
    from repro_torch.core.trellis import build_acs_tables

    dec = ViterbiDecoder(CODE_K7_CCSDS, device="cpu")
    llrs = torch.zeros(2, 8, 2)
    # LOGPROB is ported; an unknown semiring still raises
    with pytest.raises(ValueError, match="unknown semiring"):
        Semiring("maxplus")
    tb = build_acs_tables(CODE_K7_CCSDS, 2)
    blocks, lam0 = torch.zeros(4, 2, 4), torch.zeros(2, 64)
    with pytest.raises(ValueError, match="unknown semiring"):
        viterbi_forward(blocks, lam0, tb, semiring="maxplus")
    with pytest.raises(ValueError, match="unknown semiring"):
        acs_forward(
            blocks, lam0, torch.as_tensor(tb.fused_w), n_states=64,
            n_slots=4, semiring="maxplus",
        )
    # K2 has no LOGPROB variant, as the reference's has none
    with pytest.raises(TypeError, match="semiring"):
        acs_decode_fused(
            blocks, lam0, torch.zeros(4, 2, 64, dtype=torch.int8),
            torch.as_tensor(tb.fused_w), n_states=64, n_slots=4, k=7, rho=2,
            time_tile=4, semiring="logprob",
        )
    # the standard codes are ported: tail-biting and punctured input pass
    # through every entry point the reference gives them
    tbcc = ViterbiDecoder.from_standard("lte-tbcc", device="cpu")
    assert tbcc.decode_batch(torch.zeros(1, 8, 3)).shape == (1, 8)
    bits, conv = dec.decode_tailbiting(llrs, time_parallel=True)
    assert bits.shape == (2, 8) and conv.shape == (2,)
    r34 = ViterbiDecoder.from_standard("wifi-11a-r34", device="cpu")
    assert r34.decode_batch(torch.zeros(1, 8)).shape == (1, 6)
    assert r34.decode_stream_chunked(torch.zeros(1, 8)).shape == (1, 6)
    assert r34.decode_stream_tiled(torch.zeros(8)).shape == (6,)
    assert r34.decode_soft(torch.zeros(1, 8)).shape == (1, 6)
    # a circular trellis still refuses the open-trellis stream modes
    with pytest.raises(ValueError, match="open trellis"):
        tbcc.decode_stream_chunked(torch.zeros(1, 8, 3))
    with pytest.raises(ValueError, match="open"):
        tbcc.decode_stream_tiled(torch.zeros(8, 3))
    # sharded decode is ported: one CPU shard by default, and tail-biting
    # frames are refused as in the reference; from_config is ported and
    # builds a decoder from the service config
    assert dec.decode_sharded(llrs).shape == (2, 8)
    with pytest.raises(NotImplementedError, match="tail-biting"):
        tbcc.decode_sharded(torch.zeros(1, 8, 3))
    from repro_torch.configs.viterbi_k7 import CONFIG

    built = ViterbiDecoder.from_config(CONFIG, device="cpu")
    assert isinstance(built, ViterbiDecoder) and built.device.type == "cpu"
    assert built.decode_batch(llrs).shape == (2, 8)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing toolchain is an error, never a quiet switch to the
    plain version."""
    from repro_torch.kernels import viterbi_acs

    monkeypatch.setattr(viterbi_acs, "_find_nvcc", lambda: None)
    monkeypatch.setattr(viterbi_acs, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        viterbi_acs.build()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize(
    "name", ["acs_forward", "acs_decode_fused", "transfer_matrix", "semiring_compose",
             "bcjr_sweep"]
)
def test_every_kernel_build_raises_without_nvcc(monkeypatch, tmp_path, name):
    from repro_torch.kernels import viterbi_acs

    assert name in viterbi_acs.KERNELS
    monkeypatch.setattr(viterbi_acs, "_find_nvcc", lambda: None)
    monkeypatch.setattr(viterbi_acs, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match=f"nvcc not found.*{name}"):
        viterbi_acs.build(name)
    assert not list(tmp_path.iterdir())


def test_kernel_wrapper_refuses_other_devices():
    from repro_torch.kernels import acs_decode_fused, acs_forward, transfer_matrix

    meta = torch.zeros(4, 2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        acs_forward(
            meta, torch.zeros(2, 64, device="meta"),
            torch.zeros(68, 256, device="meta"), n_states=64, n_slots=4,
        )
    with pytest.raises(ValueError, match="several devices"):
        acs_forward(
            meta, torch.zeros(2, 64), torch.zeros(68, 256),
            n_states=64, n_slots=4,
        )
    ring = torch.zeros(8, 2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        acs_decode_fused(
            meta, torch.zeros(2, 64, device="meta"), ring,
            torch.zeros(68, 256, device="meta"), n_states=64, n_slots=4,
            k=7, rho=2, time_tile=4, pack_survivors=True,
        )
    with pytest.raises(ValueError, match="several devices"):
        acs_decode_fused(
            meta, torch.zeros(2, 64), ring, torch.zeros(68, 256),
            n_states=64, n_slots=4, k=7, rho=2, time_tile=4,
        )
    with pytest.raises(ValueError, match="unsupported device"):
        transfer_matrix(
            meta, torch.zeros(68, 256, device="meta"), n_states=64,
            n_slots=4, transfer_tile=4,
        )
    with pytest.raises(ValueError, match="several devices"):
        transfer_matrix(
            meta, torch.zeros(68, 256), n_states=64, n_slots=4,
            transfer_tile=4,
        )
