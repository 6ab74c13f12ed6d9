"""The optimisers: ``repro_torch.optim.adamw`` and ``optim.compress``
against the reference's ``repro.optim`` on the same numpy inputs.

AdamW is fed the same gradients step by step over the warm-up, the
cosine and steps that clip, and must hold to 1e-6.  The compressed
data-parallel step needs four JAX devices, which
``--xla_force_host_platform_device_count`` gives only before JAX starts,
so the reference runs in a subprocess: the reference test's
least-squares problem, 60 steps, writing each step's loss, parameters
and every device's own error-feedback buffer (R12: they differ); the
port's four logical CPU shards must hold each of them.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro_torch.optim import adamw, compress

REPO = Path(__file__).resolve().parent.parent
ADAMW_TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(rng):
    return {"a": {"w": rng.normal(0, 1, (5, 3)).astype(np.float32)},
            "b": rng.normal(0, 1, (4,)).astype(np.float32)}


def _as_torch(tree):
    return adamw.tree_map(lambda x: torch.as_tensor(np.asarray(x)), tree)


def _as_jnp(tree):
    return adamw.tree_map(jnp.asarray, tree)


def _close_trees(got, want, label, **tol):
    got_l, want_l = adamw.tree_leaves(got), adamw.tree_leaves(want)
    assert len(got_l) == len(want_l), label
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=label,
                                   **(tol or ADAMW_TOL))


def test_cosine_schedule_matches_the_reference():
    cfg = dict(peak_lr=1e-3, warmup_steps=5, total_steps=20, min_lr_ratio=0.1)
    ref = ref_adamw.cosine_schedule(ref_adamw.AdamWConfig(**cfg))
    port = adamw.cosine_schedule(adamw.AdamWConfig(**cfg))
    for s in range(0, 26):
        want = float(ref(jnp.asarray(s, jnp.int32)))
        got = port(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, err_msg=f"step {s}")


def test_global_norm_sums_leaves_in_the_reference_order():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    want = float(ref_adamw.global_norm(_as_jnp(tree)))
    np.testing.assert_allclose(float(adamw.global_norm(_as_torch(tree))), want,
                               rtol=1e-6)
    assert adamw.tree_leaves({"b": 1, "a": {"z": 2, "c": 3}}) == [3, 2, 1]


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_over_warmup_cosine_and_clipping(clip_norm):
    """12 steps of warm-up (3), cosine (to 10) and past its end, fed the
    same numpy gradients; with clip_norm=1 the gradients of norm about 4
    clip on every step, with 1e9 none does."""
    rng = np.random.default_rng(0)
    kw = dict(peak_lr=1e-2, warmup_steps=3, total_steps=10, weight_decay=0.1,
              clip_norm=clip_norm, min_lr_ratio=0.1)
    rcfg, pcfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    p0 = _tree(rng)
    rp, pp = _as_jnp(p0), _as_torch(p0)
    rs, ps = ref_adamw.adamw_init(rp), adamw.adamw_init(pp)
    assert ps.step.dtype == torch.int32 and int(ps.step) == 0
    clipped = []
    for s in range(12):
        g = _tree(rng)
        rp, rs, rstats = ref_adamw.adamw_update(_as_jnp(g), rs, rp, rcfg)
        pp_new, ps_new, pstats = adamw.adamw_update(_as_torch(g), ps, pp, pcfg)
        # functional: the inputs are untouched
        _close_trees(pp, adamw.tree_map(np.asarray, pp), "inputs")
        pp, ps = pp_new, ps_new
        label = f"clip_norm={clip_norm} step {s + 1}"
        _close_trees(pp, rp, f"{label}: params")
        _close_trees(ps.m, rs.m, f"{label}: m")
        _close_trees(ps.v, rs.v, f"{label}: v")
        assert int(ps.step) == int(rs.step) == s + 1
        for key in ("lr", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(pstats[key]), float(rstats[key]),
                                       rtol=1e-6, err_msg=f"{label}: {key}")
        clipped.append(float(pstats["clip_scale"]) < 1.0)
    assert all(clipped) if clip_norm == 1.0 else not any(clipped)


def test_adamw_matches_the_hand_rolled_step():
    """The reference's own one-step check (tests/test_runtime.py), on the
    port."""
    rng = np.random.default_rng(1)
    p = {"w": torch.as_tensor(rng.normal(0, 1, (5, 3)), dtype=torch.float32)}
    g = {"w": torch.as_tensor(rng.normal(0, 1, (5, 3)), dtype=torch.float32)}
    cfg = adamw.AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=10,
                            weight_decay=0.1, clip_norm=1e9, min_lr_ratio=1.0)
    newp, st2, _ = adamw.adamw_update(g, adamw.adamw_init(p), p, cfg)
    gn, pn = g["w"].numpy(), p["w"].numpy()
    mhat = 0.1 * gn / (1 - 0.9)
    vhat = 0.05 * gn * gn / (1 - 0.95)
    want = pn - 1e-2 * (mhat / (np.sqrt(vhat) + 1e-8) + 0.1 * pn)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-5)
    assert int(st2.step) == 1


def test_int8_quantization_roundtrip():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 3, (64, 32)), dtype=torch.float32)
    q, s = compress.quantize_int8(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    back = compress.dequantize_int8(q, s)
    assert float((back - x).abs().max()) <= float(s) * 0.5 + 1e-6


def test_int8_quantization_matches_the_reference_and_rounds_half_to_even():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (256,)).astype(np.float32)
    x[:4] = [127.0, 0.5, 1.5, -2.5]  # scale 1 (+1e-30): .5 ties round to even
    rq, rs = ref_compress.quantize_int8(jnp.asarray(x))
    pq, ps = compress.quantize_int8(torch.as_tensor(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(rq))
    assert float(ps) == float(rs)
    assert pq[1:4].tolist() == [0, 2, -2]


REF_DP = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.optim.compress import make_dp_train_step_compressed
mesh = jax.make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
W = jnp.asarray(rng.normal(0, 1, (16, 1)), jnp.float32)
def loss_fn(params, batch):
    x, y = batch
    pred = x @ params["w"]
    return jnp.mean((pred - y) ** 2)
params = {"w": jnp.zeros((16, 1))}
err = jax.tree.map(jnp.zeros_like, params)
# jitted: the eager shard_map retraces every step (about 2 s a step);
# the two agree within 1.5e-5 on every device's residual
step = jax.jit(make_dp_train_step_compressed(loss_fn, mesh, lr=0.1))
losses, ws, errs = [], [], []
with mesh:
    for i in range(60):
        x = jnp.asarray(rng.normal(0, 1, (32, 16)), jnp.float32)
        y = x @ W
        params, err, loss = step(params, err, (x, y))
        losses.append(float(loss))
        ws.append(np.asarray(params["w"]))
        shards = sorted(err["w"].addressable_shards, key=lambda s: s.device.id)
        errs.append(np.stack([np.asarray(s.data) for s in shards]))
np.savez(sys.argv[1], losses=np.asarray(losses), w=np.stack(ws),
         err=np.stack(errs), host_err=np.asarray(err["w"]))
"""


@pytest.fixture(scope="module")
def reference_dp(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp4") / "dp.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", REF_DP, str(out)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(out))


def _port_dp(steps=60):
    """The same problem on the port: four logical CPU shards."""
    from repro_torch.distributed.decoder import frame_mesh

    mesh = frame_mesh(4, device="cpu")
    rng = np.random.default_rng(0)
    W = torch.as_tensor(rng.normal(0, 1, (16, 1)), dtype=torch.float32)

    def loss_fn(params, batch):
        x, y = batch
        return torch.mean((x @ params["w"] - y) ** 2)

    params = {"w": torch.zeros((16, 1))}
    err = compress.init_residuals(params, mesh)
    step = compress.make_dp_train_step_compressed(loss_fn, mesh, lr=0.1)
    losses, ws, errs = [], [], []
    for _ in range(steps):
        x = torch.as_tensor(rng.normal(0, 1, (32, 16)), dtype=torch.float32)
        params, err, loss = step(params, err, (x, x @ W))
        losses.append(float(loss))
        ws.append(params["w"].numpy())
        errs.append(np.stack([e["w"].numpy() for e in err]))
    return np.asarray(losses), np.stack(ws), np.stack(errs)


def test_compressed_dp_holds_each_devices_residual(reference_dp):
    """Losses, parameters and every shard's residual after each of 60
    steps, against the reference's 4-device run.  The residuals are a
    shard's own (R12): they differ between shards, and shard 0's is what
    the reference's host reads."""
    losses, ws, errs = _port_dp()
    ref = reference_dp
    # the reference's devices keep residuals that differ from one another
    assert np.abs(ref["err"][0, 0] - ref["err"][0, 1]).max() > 1e-3
    np.testing.assert_array_equal(ref["host_err"], ref["err"][-1, 0])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ws, ref["w"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(errs, ref["err"], rtol=1e-4, atol=1e-5)
    assert losses[-1] < 0.05 * losses[0], (losses[0], losses[-1])


def test_compressed_psum_sums_int8_payloads_under_the_mean_scale():
    """Each shard's own quantisation, the int8 payloads summed exactly,
    dequantised once with the shards' mean scale (the reference's pmean),
    over the shard count."""
    rng = np.random.default_rng(5)
    gs = [torch.as_tensor(rng.normal(0, 1, (8, 3)), dtype=torch.float32)
          for _ in range(4)]
    red = compress.compressed_psum(gs)
    parts = [compress.quantize_int8(g) for g in gs]
    qsum = sum(q.numpy().astype(np.int32) for q, _ in parts)
    scale = np.float32(sum(float(s) for _, s in parts) / 4)
    np.testing.assert_allclose(red.numpy(), qsum.astype(np.float32) * scale / 4,
                               rtol=1e-6)
    from repro_torch.distributed.decoder import frame_mesh

    step = compress.make_dp_train_step_compressed(lambda p, b: p["w"].sum(),
                                                  frame_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="residual trees"):
        step({"w": torch.zeros(2)}, [], torch.zeros(4, 2))
    with pytest.raises(ValueError, match="does not split"):
        step({"w": torch.zeros(2)}, [{"w": torch.zeros(2)}] * 2, torch.zeros(3, 2))
