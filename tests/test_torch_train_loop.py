"""The LM testbed's training loop: ``TokenStream``, the tree half of
``runtime/checkpoint.py``, ``train.loop.train`` and ``launch.train``,
against the reference's where the two can meet.

``TokenStream``'s draws are a ``torch.Generator``'s, not ``jax.random``'s,
so it is held to its structure and determinism.  Checkpoints are held to
the reference's key spelling and restore across the packages in both
directions; after a restore one step of each package on the same batch
must agree as ``tests/test_torch_train.py``'s contract says.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lm import smoke, to_numpy
from repro.optim import adamw as ref_adamw
from repro.runtime import checkpoint as ref_ckpt
from repro.train import step as ref_step
from repro_torch.data.pipeline import TokenStream
from repro_torch.optim import adamw
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.train import step

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def _stream(**kw):
    base = dict(vocab_size=100, batch=3, seq_len=16, seed=3, device="cpu")
    return TokenStream(**{**base, **kw})


def test_token_stream_structure():
    V, S = 100, 16
    b = _stream(prefix_len=4, d_model=8).batch_at(7)
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (3, S)
    assert toks.dtype == labels.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < V
    # every even position copies the token before it, halved (position 0
    # the last token's, through the roll; S is even so that one is odd)
    prev = torch.roll(toks, 1, dims=1)
    assert torch.equal(toks[:, 0::2], (prev[:, 0::2] // 2) % V)
    # labels are the tokens rolled left, the last one masked
    assert torch.equal(labels[:, :-1], toks[:, 1:])
    assert bool((labels[:, -1] == -1).all())
    pe = b["prefix_embeds"]
    assert pe.shape == (3, 4, 8) and pe.dtype == torch.bfloat16
    assert 0.005 < float(pe.float().std()) < 0.05
    assert "prefix_embeds" not in _stream().batch_at(0)
    # Zipf-ish: int(V u^3) has mean about V/4 - 1/2 at the odd positions
    odd = _stream(batch=64, seq_len=256).batch_at(0)["tokens"][:, 1::2].float()
    assert 20.0 < float(odd.mean()) < 29.0
    assert float((odd < V / 8).float().mean()) > 0.45  # P(u^3 < 1/8) = 1/2


def test_token_stream_determinism():
    a, b = _stream().batch_at(7), _stream().batch_at(7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], _stream().batch_at(8)["tokens"])
    assert not torch.equal(a["tokens"], _stream(host_id=1).batch_at(7)["tokens"])
    assert not torch.equal(a["tokens"], _stream(seed=4).batch_at(7)["tokens"])
    it = iter(_stream())
    first, second = next(it), next(it)
    assert torch.equal(first["tokens"], _stream().batch_at(0)["tokens"])
    assert torch.equal(second["tokens"], _stream().batch_at(1)["tokens"])


def _state_trees():
    """A reference (params, OptState) and the port's, the same numbers."""
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    ref = {"params": {"a": {"w": jnp.asarray(w)}},
           "opt": ref_adamw.OptState(step=jnp.asarray(3, jnp.int32),
                                     m={"a": {"w": jnp.asarray(w + 1)}},
                                     v={"a": {"w": jnp.asarray(w + 2)}})}
    port = {"params": {"a": {"w": torch.as_tensor(w)}},
            "opt": adamw.OptState(step=torch.tensor(3, dtype=torch.int32),
                                  m={"a": {"w": torch.as_tensor(w + 1)}},
                                  v={"a": {"w": torch.as_tensor(w + 2)}})}
    return ref, port


def test_checkpoint_keys_spell_the_reference_tree_paths(tmp_path):
    ref, port = _state_trees()
    want = ["['opt'].m['a']['w']", "['opt'].step", "['opt'].v['a']['w']",
            "['params']['a']['w']"]
    assert sorted(ref_ckpt._flatten(ref)) == want
    assert sorted(ckpt._flatten(port)) == want
    ckpt.save(tmp_path / "p", 5, port)
    ref_ckpt.save(tmp_path / "r", 5, ref)
    for d in ("p", "r"):
        man = json.loads((tmp_path / d / "step_000000005" / "manifest.json").read_text())
        assert man["keys"] == want and man["dtypes"]["['opt'].step"] == "int32"
    # lists and tuples index as the reference's paths do
    assert list(ckpt._flatten({"x": [np.zeros(1), (np.ones(1),)]})) == [
        "['x'][0]", "['x'][1][0]"]


def test_checkpoint_restores_across_packages(tmp_path):
    ref, port = _state_trees()
    ref_ckpt.save(tmp_path / "r", 2, ref)
    got = ckpt.restore(tmp_path / "r", 2, port)
    assert isinstance(got["opt"], adamw.OptState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 3
    for a, b in zip(adamw.tree_leaves(got["params"]) + adamw.tree_leaves(got["opt"].m),
                    adamw.tree_leaves(port["params"]) + adamw.tree_leaves(port["opt"].m)):
        assert a.device == b.device and torch.equal(a, b)
    ckpt.save(tmp_path / "p", 2, port)
    back = ref_ckpt.restore(tmp_path / "p", 2, ref)
    assert int(back["opt"].step) == 3
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 back, ref)


def _one_step_each(rc, pc, ref_state, port_state, batch):
    """One step of each package from the given states, on one batch."""
    tokens, labels = batch
    r_new, _, r_m = jax.jit(ref_step.make_train_step(rc, ref_adamw.AdamWConfig(**OPT)))(
        ref_state["params"], ref_state["opt"],
        {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    p_new, p_opt, p_m = step.make_train_step(pc, adamw.AdamWConfig(**OPT))(
        port_state["params"], port_state["opt"],
        {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)})
    np.testing.assert_allclose(float(p_m["loss"]), float(r_m["loss"]), rtol=1e-5)
    lr = float(r_m["lr"])
    # the contract's bound for any entry: AdamW's g / (|g| + eps) moves a
    # near-zero gradient's entry by up to a step in either package
    for a, b in zip(adamw.tree_leaves(p_new), jax.tree.leaves(r_new)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2 * lr + 1e-6)
    return p_opt


def test_a_train_checkpoint_restores_in_the_other_package_and_trains(tmp_path):
    """A reference train state after one step, saved by the reference,
    restored by the port; the port's state saved by the port, restored by
    the reference; then one step of each on the same batch."""
    rc, pc = smoke("smollm-135m", activation_dtype="float32")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, rc.vocab_size, (2, 32)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    r_params, r_opt = ref_step.init_train_state(rc, jax.random.PRNGKey(0))
    r_params, r_opt, _ = jax.jit(ref_step.make_train_step(
        rc, ref_adamw.AdamWConfig(**OPT)))(
        r_params, r_opt, {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    ref_state = {"params": r_params, "opt": r_opt}
    ref_ckpt.save(tmp_path / "r", 0, ref_state)

    like_p, like_o = step.init_train_state(pc, device="cpu")
    port_state = ckpt.restore(tmp_path / "r", 0, {"params": like_p, "opt": like_o})
    assert int(port_state["opt"].step) == 1
    for a, b in zip(adamw.tree_leaves(port_state["params"]), jax.tree.leaves(r_params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the carried form gives the same state
    carried = step.opt_state_from_numpy(to_numpy(r_opt), device="cpu")
    for a, b in zip(adamw.tree_leaves(carried.v), adamw.tree_leaves(port_state["opt"].v)):
        assert torch.equal(a, b)

    tokens2 = rng.integers(0, rc.vocab_size, (2, 32)).astype(np.int32)
    labels2 = np.roll(tokens2, -1, axis=1)
    p_opt = _one_step_each(rc, pc, ref_state, port_state, (tokens2, labels2))
    assert int(p_opt.step) == 2

    # and back: the port's state through the reference
    ckpt.save(tmp_path / "p", 1, port_state)
    ref_back = ref_ckpt.restore(tmp_path / "p", 1, ref_state)
    assert int(ref_back["opt"].step) == 1
    _one_step_each(rc, pc, ref_back, port_state, (tokens2, labels2))


def test_restore_puts_leaves_on_the_like_device_and_refuses_bf16(tmp_path):
    t = {"a": torch.ones(3), "b": np.zeros(2, np.int64)}
    ckpt.save(tmp_path, 1, t)
    got = ckpt.restore(tmp_path, 1, t)
    assert isinstance(got["a"], torch.Tensor) and got["a"].device.type == "cpu"
    assert isinstance(got["b"], np.ndarray) and got["b"].dtype == np.int64
    with pytest.raises(TypeError, match="bf16"):
        ckpt.save(tmp_path, 2, {"a": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="bf16"):
        ckpt.save_async(tmp_path, 3, {"a": torch.ones(2, dtype=torch.bfloat16)})
    # a reference checkpoint of a bf16 leaf is refused, not misread
    ref_ckpt.save(tmp_path / "r", 1, {"a": jnp.ones(2, jnp.bfloat16)})
    with pytest.raises(TypeError, match="bf16"):
        ckpt.restore(tmp_path / "r", 1, {"a": torch.ones(2)})


def test_save_async_error_surfaced(tmp_path):
    """The reference's tests/test_chaos.py:208 on the port: a failed
    background write re-raises from result()/join(), and the manager
    surfaces it on the next wait."""
    clobber = tmp_path / "not_a_dir"
    clobber.write_text("a file where the step dir must go")
    h = ckpt.save_async(clobber / "x", 0, {"a": torch.zeros(3)})
    with pytest.raises(OSError):
        h.result(timeout=30.0)
    assert h.done() and isinstance(h.exception(), OSError)
    with pytest.raises(OSError):
        h.join(timeout=30.0)

    mgr = ckpt.CheckpointManager(clobber / "y", interval=1)
    assert mgr.maybe_save(0, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr2 = ckpt.CheckpointManager(clobber / "z", interval=1)
    assert mgr2.maybe_save(0, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        mgr2.maybe_save(1, {"a": torch.ones(2)})  # the next boundary
    ok = ckpt.CheckpointManager(tmp_path / "ok", interval=1)
    ok.maybe_save(0, {"a": torch.ones(2)})
    ok.wait()
    assert ckpt.latest_step(tmp_path / "ok") == 0


def test_manager_keeps_the_last_and_skips_torn_writes(tmp_path):
    t = {"a": torch.randn(4, 8), "nested": {"b": torch.randn(3), "c": torch.tensor(7)}}
    mgr = ckpt.CheckpointManager(tmp_path, interval=2, keep=2)
    saved = [s for s in range(9) if mgr.maybe_save(s, t)]
    mgr.wait()
    assert saved == [0, 2, 4, 6, 8]
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.glob("step_*"))
    assert steps == [6, 8] and ckpt.latest_step(tmp_path) == 8
    torn = tmp_path / "step_000000009"
    torn.mkdir()
    (torn / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(tmp_path) == 8
    got = ckpt.restore(tmp_path, 8, t)
    assert torch.equal(got["nested"]["c"], t["nested"]["c"])
    assert torch.equal(got["a"], t["a"])


def test_train_resume_equivalence(tmp_path):
    """Six steps straight == three, then a restart that resumes from the
    step-3 checkpoint (the reference's test and tolerance)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.loop import TrainLoopConfig, train

    cfg = get_smoke_config("smollm-135m")
    kw = dict(batch=2, seq_len=32, ckpt_interval=3, log_interval=100)
    p1, o1, _ = train(cfg, TrainLoopConfig(steps=6, ckpt_dir=str(tmp_path / "a"), **kw),
                      log_fn=lambda *a: None, device="cpu")
    train(cfg, TrainLoopConfig(steps=3, ckpt_dir=str(tmp_path / "b"), **kw),
          log_fn=lambda *a: None, device="cpu")
    # steps 0-2 with interval 3: the checkpoint of step 0 (as in the reference)
    assert ckpt.latest_step(tmp_path / "b") == 0
    logs = []
    p2, o2, hist = train(cfg, TrainLoopConfig(steps=6, ckpt_dir=str(tmp_path / "b"), **kw),
                         log_fn=logs.append, device="cpu")
    assert logs[0] == "[train] resumed from checkpoint step 0"
    assert [s for s, _ in hist] == [5]
    assert int(o1.step) == int(o2.step) == 6
    for a, b in zip(adamw.tree_leaves(p1), adamw.tree_leaves(p2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_launch_train_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    hist = launch_train.main([
        "--arch", "mamba2-370m", "--smoke", "--steps", "3", "--batch", "2",
        "--seq", "32", "--ckpt-dir", str(tmp_path), "--ckpt-interval", "2",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert [s for s, _ in hist] == [0, 2]
    assert all(np.isfinite(loss) for _, loss in hist)
    assert "[train] step     0 loss" in out and "[train] step     2 loss" in out
    assert ckpt.latest_step(tmp_path) == 2
    assert launch_train._parser().parse_args([]).device is None
