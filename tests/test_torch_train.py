"""The LM testbed's train step: ``repro_torch.train.step`` against the
reference's ``repro.train.step`` on the ten smoke configs.

Both packages start from the reference's ``init_params`` (carried into
the port as numpy) and take the same numpy batch.  The precision
contract (``train/step.py``'s docstring): at f32 activations the loss
holds within rtol 1e-5, each gradient leaf within 1e-4 of its largest
magnitude, the moments likewise, and the new parameters within 1e-3 x lr
where the reference's gradient is at least 1e-3 of its leaf's largest
(elsewhere AdamW's ``g / (|g| + eps)`` may turn a rounding difference
into up to a whole step, so within 2 x lr); at bf16 the loss within
2e-2 with finite gradients, the MoE archs at f32 only.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lm import ARCHS, MOE_ARCHS, carried_params, inputs, smoke
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.optim import adamw
from repro_torch.train import step

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each leaf's largest magnitude
BF16_LOSS_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """This module's eager CPU work on two threads: with a test worker a
    core, more threads oversubscribe the host (and the module runs faster
    on two)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(cfg, B=2, S=32, seed=0):
    """numpy tokens, labels (rolled, the last and one other masked) and a
    frontend arch's prefix embeddings, as both packages' batches."""
    tokens, prefix = inputs(cfg, B=B, S=S, seed=seed)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    ref = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    port = {"tokens": torch.as_tensor(tokens), "labels": torch.as_tensor(labels)}
    if prefix is not None:
        ref["prefix_embeds"] = jnp.asarray(prefix)
        port["prefix_embeds"] = torch.as_tensor(prefix)
    return ref, port


@functools.lru_cache(maxsize=None)
def _ref_grad(cfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_step.lm_loss(p, cfg, b), has_aux=True))


@functools.lru_cache(maxsize=None)
def _ref_train_step(cfg, microbatches):
    return jax.jit(ref_step.make_train_step(
        cfg, ref_adamw.AdamWConfig(**OPT), microbatches=microbatches))


def _leaves(tree):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
            else x.detach().float().numpy() for x in adamw.tree_leaves(tree)]


def _assert_leafwise(got, want, label, tol=GRAD_TOL):
    """Every leaf within ``tol`` of that leaf's largest magnitude."""
    g_l, w_l = _leaves(got), _leaves(want)
    assert len(g_l) == len(w_l), label
    for i, (g, w) in enumerate(zip(g_l, w_l)):
        assert g.shape == w.shape, (label, i)
        err = np.abs(g - w).max()
        assert err <= tol * max(np.abs(w).max(), 1e-30), (label, i, err, np.abs(w).max())


def _assert_new_params(got, want, p0, grads, lr, label):
    """The step's new parameters: within 1e-3 x lr (+ f32 rounding of
    the parameter) where the reference's gradient is at least 1e-3 of its
    leaf's largest, within 2 x lr elsewhere."""
    for i, (g, w, p, gr) in enumerate(zip(_leaves(got), _leaves(want), _leaves(p0),
                                          _leaves(grads))):
        err = np.abs(g - w)
        big = np.abs(gr) >= 1e-3 * np.abs(gr).max()
        slack = 1e-6 * np.abs(p)
        assert (err <= 1e-3 * lr + slack)[big].all(), (label, i, err[big].max() / lr)
        assert (err <= 2 * lr + slack).all(), (label, i, err.max() / lr)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_and_one_step_at_f32(arch):
    rc, pc = smoke(arch, activation_dtype="float32")
    ref_p, port_p = carried_params(rc)
    rb, pb = _batch(rc)
    (r_loss, r_metrics), r_grads = _ref_grad(rc)(ref_p, rb)
    p_loss, p_metrics = step.lm_loss(port_p, pc, pb)
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=LOSS_RTOL)
    for key in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(float(p_metrics[key]), float(r_metrics[key]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    if arch in MOE_ARCHS:
        assert float(p_metrics["aux_loss"]) > 0
    _, _, p_grads = step._grad_fn(pc)(port_p, pb)
    _assert_leafwise(p_grads, r_grads, f"{arch}: grads")

    r_new, r_opt, r_m = _ref_train_step(rc, 1)(ref_p, ref_adamw.adamw_init(ref_p), rb)
    p_new, p_opt, p_m = step.make_train_step(pc, adamw.AdamWConfig(**OPT))(
        port_p, adamw.adamw_init(port_p), pb)
    assert sorted(p_m) == sorted(r_m)
    for key in r_m:
        np.testing.assert_allclose(float(p_m[key]), float(r_m[key]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    assert int(p_opt.step) == int(r_opt.step) == 1
    _assert_leafwise(p_opt.m, r_opt.m, f"{arch}: m")
    _assert_leafwise(p_opt.v, r_opt.v, f"{arch}: v", tol=2 * GRAD_TOL)
    _assert_new_params(p_new, r_new, ref_p, r_grads, float(r_m["lr"]), arch)


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m", "mixtral-8x7b"])
def test_two_microbatches(arch):
    """Gradients summed over two slices in order and divided, the loss
    likewise, the metrics the last slice's: against the reference's
    scanned accumulation."""
    rc, pc = smoke(arch, activation_dtype="float32")
    ref_p, port_p = carried_params(rc)
    rb, pb = _batch(rc, B=4)
    r_new, r_opt, r_m = _ref_train_step(rc, 2)(ref_p, ref_adamw.adamw_init(ref_p), rb)
    p_new, p_opt, p_m = step.make_train_step(
        pc, adamw.AdamWConfig(**OPT), microbatches=2)(
        port_p, adamw.adamw_init(port_p), pb)
    for key in r_m:
        np.testing.assert_allclose(float(p_m[key]), float(r_m[key]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=key)
    _assert_leafwise(p_opt.m, r_opt.m, f"{arch}: m")
    # the accumulated gradient, recovered from the first moment
    grads = jax.tree.map(lambda m: m / 0.1, r_opt.m)
    _assert_new_params(p_new, r_new, ref_p, grads, float(r_m["lr"]), arch)
    # the last slice's metrics, not the mean
    _, last = step.lm_loss(port_p, pc, {k: v[2:] for k, v in pb.items()})
    np.testing.assert_allclose(float(p_m["ce_loss"]), float(last["ce_loss"]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        step.make_train_step(pc, microbatches=3)(port_p, adamw.adamw_init(port_p), pb)


@pytest.mark.parametrize("arch", ["smollm-135m", "hymba-1.5b", "arctic-480b",
                                  "mamba2-370m"])
def test_remat_changes_no_value(arch, monkeypatch):
    """``remat=True`` checkpoints each layer (n_layers calls a forward)
    and gives the same loss and gradients, bit for bit, as ``False``."""
    rc, pc = smoke(arch, activation_dtype="float32")
    _, port_p = carried_params(rc)
    _, pb = _batch(pc)
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(pc, remat=remat)
        calls.clear()
        out[remat] = step._grad_fn(cfg)(port_p, pb)
        assert len(calls) == (cfg.n_layers if remat else 0)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(adamw.tree_leaves(out[True][2]), adamw.tree_leaves(out[False][2])):
        assert torch.equal(a, b)
    # without gradients no layer is checkpointed
    calls.clear()
    with torch.no_grad():
        step.lm_loss(port_p, pc, pb)
    assert not calls


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE_ARCHS])
def test_bf16_loss_and_finite_grads(arch):
    """At the configs' bf16 activations the packages round at other
    places: the loss holds within 2e-2 and every gradient is finite."""
    rc, pc = smoke(arch)
    assert pc.activation_dtype == "bfloat16"
    ref_p, port_p = carried_params(rc)
    rb, pb = _batch(rc)
    r_loss, _ = jax.jit(lambda p, b: ref_step.lm_loss(p, rc, b))(ref_p, rb)
    p_loss, _, p_grads = step._grad_fn(pc)(port_p, pb)
    np.testing.assert_allclose(float(p_loss), float(r_loss), atol=BF16_LOSS_ATOL)
    assert all(bool(torch.isfinite(g).all()) for g in adamw.tree_leaves(p_grads))
    assert all(g.dtype == torch.float32 for g in adamw.tree_leaves(p_grads))


def test_gather_loss_equals_the_one_hot_form():
    """``torch.gather`` of max(labels, 0) against the reference's one-hot
    reduction, on the same f32 logits: equal bit for bit."""
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (2, 7, 50)).astype(np.float32)
    labels = rng.integers(-1, 50, (2, 7))
    oh = jax.nn.one_hot(jnp.maximum(labels, 0), 50, dtype=jnp.float32)
    want = np.asarray(jnp.sum(jnp.asarray(logits) * oh, axis=-1))
    got = torch.gather(torch.as_tensor(logits), -1,
                       torch.as_tensor(np.maximum(labels, 0))[..., None])[..., 0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_module_form_trains_after_requires_grad():
    """``LanguageModel.requires_grad_(True)`` makes its weights trainable:
    ``backward`` of its train-mode loss fills each weight's ``.grad`` with
    the functional step's gradient."""
    from repro_torch.models.lm import LanguageModel, _flatten

    rc, pc = smoke("smollm-135m", activation_dtype="float32")
    _, port_p = carried_params(rc)
    _, pb = _batch(pc)
    model = LanguageModel(pc, adamw.tree_map(torch.clone, port_p))
    assert not any(p.requires_grad for p in model.parameters())
    model.requires_grad_(True)
    loss, _ = step.lm_loss(model.params, pc, pb)
    loss.backward()
    _, _, grads = step._grad_fn(pc)(port_p, pb)
    for name, g in _flatten(grads):
        torch.testing.assert_close(model.weights[name].grad, g, rtol=0, atol=0)
