"""GPipe pipeline parallelism: ``repro_torch.distributed.pipeline`` against
the sequential layer stack and the reference's ``pipeline_apply``.

The reference test (``tests/test_distributed.py:197-223``): 4 stages of
``tanh(x @ w)``, d = 16, 8 rows in 4 microbatches, within rtol 1e-5 of
the sequential stack, and ``bubble_fraction(4, 4) == 3/7``.  The port's
pipeline equals the sequential stack run a microbatch at a time bit for
bit; against the whole-batch stack and the reference's output it holds
rtol 1e-5 with atol 1e-6, since the CPU's BLAS rounds a 2-row product
otherwise than an 8-row one (f32 ulps of values near zero).  The
reference's ``shard_map`` needs four JAX devices, which exist only when
``--xla_force_host_platform_device_count`` is set before JAX starts, so
it runs in a subprocess that writes its output for the same weights.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.distributed.pipeline import bubble_fraction as ref_bubble_fraction
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.launch.mesh import make_test_mesh

REPO = Path(__file__).resolve().parent.parent
N_STAGES, D = 4, 16

REF_PIPE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed.pipeline import pipeline_apply
mesh = jax.make_mesh((4,), ("pipe",))
data = np.load(sys.argv[1])
Ws, x = jnp.asarray(data["Ws"]), jnp.asarray(data["x"])
def stage_fn(w, x):
    return jnp.tanh(x @ w)
with mesh:
    got = jax.jit(pipeline_apply(stage_fn, mesh, n_microbatches=4))(Ws, x)
np.save(sys.argv[2], np.asarray(got))
"""


def _inputs():
    rng = np.random.default_rng(0)
    Ws = rng.normal(0, 0.5, (N_STAGES, D, D)).astype(np.float32)
    x = rng.normal(0, 1, (8, D)).astype(np.float32)
    return Ws, x


def _stage_fn(w, x):
    return torch.tanh(x @ w)


def _sequential(Ws, x):
    for i in range(Ws.shape[0]):
        x = _stage_fn(Ws[i], x)
    return x


@pytest.fixture(scope="module")
def reference_pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    Ws, x = _inputs()
    np.savez(tmp / "in.npz", Ws=Ws, x=x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", REF_PIPE, str(tmp / "in.npz"),
                          str(tmp / "out.npy")], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return np.load(tmp / "out.npy")


def test_pipeline_matches_sequential_and_the_reference(reference_pipeline):
    Ws, x = (torch.as_tensor(a) for a in _inputs())
    mesh = make_test_mesh((N_STAGES,), ("pipe",), device="cpu")
    with shd.collective_log() as log:
        got = pipeline_apply(_stage_fn, mesh, n_microbatches=4)(Ws, x)
    per_mb = torch.cat([_sequential(Ws, mb) for mb in x.split(2)])
    assert torch.equal(got, per_mb)
    np.testing.assert_allclose(got.numpy(), _sequential(Ws, x).numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), reference_pipeline, rtol=1e-5, atol=1e-6)
    # one move a microbatch between each pair of neighbouring stages
    assert [r["kind"] for r in log] == ["collective-permute"] * (4 * (N_STAGES - 1))
    assert all(r["result_bytes"] == 2 * D * 4 for r in log)


def test_pipeline_takes_stage_pieces_on_a_two_axis_mesh():
    """Stacked stage parameters laid out over "pipe" on a (pipe, data)
    mesh: each stage takes the piece its shard owns."""
    Ws, x = (torch.as_tensor(a) for a in _inputs())
    mesh = make_test_mesh((N_STAGES, 2), ("pipe", "data"), device="cpu")
    pieces = shd.shard(Ws, mesh, shd.P("pipe"))
    got = pipeline_apply(_stage_fn, mesh, n_microbatches=2)(pieces, x)
    assert torch.equal(got, torch.cat([_sequential(Ws, mb) for mb in x.split(4)]))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_stage_fn, mesh, n_microbatches=3)(Ws, x)


@pytest.mark.parametrize("stages,micro", [(4, 4), (5, 4), (2, 8), (1, 3)])
def test_bubble_fraction(stages, micro):
    assert bubble_fraction(stages, micro) == ref_bubble_fraction(stages, micro)
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-9
