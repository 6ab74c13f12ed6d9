"""Helpers of the LM-testbed tests (``tests/test_torch_lm*.py``): the
reference's parameters carried into the port, numpy-seeded inputs, the
reference's jitted entry points and comparisons of trees."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

ARCHS = ["qwen1.5-32b", "glm4-9b", "minitron-4b", "smollm-135m",
         "musicgen-large", "internvl2-2b", "arctic-480b", "mixtral-8x7b",
         "hymba-1.5b", "mamba2-370m"]
MOE_ARCHS = ["arctic-480b", "mixtral-8x7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def smoke(arch, **overrides):
    """The reference's smoke config of ``arch`` and the port's, with the
    same overrides (e.g. ``activation_dtype="float32"``)."""
    from repro.configs import get_smoke_config as ref_smoke

    from repro_torch.configs import get_smoke_config

    return (dataclasses.replace(ref_smoke(arch), **overrides),
            dataclasses.replace(get_smoke_config(arch), **overrides))


def to_numpy(tree):
    """A reference pytree as nested dicts of numpy arrays (bf16 stays
    ml_dtypes' bfloat16, which ``params_from_numpy`` reads)."""
    return jax.tree.map(np.asarray, tree)


def carried_params(ref_cfg, seed=0):
    """The reference's ``init_params`` from ``PRNGKey(seed)`` and the same
    values as the port's tensors on the CPU.  The tree depends only on
    the widths and the parameter dtype, so one draw serves every
    variant of a config that keeps them (the callers never write to it)."""
    widths = dataclasses.replace(
        ref_cfg, name="", activation_dtype="float32", kv_cache_dtype="bfloat16",
        decode_ring_write=True, decode_deferred_write=True, causal_skip=False)
    return _carried(widths, seed)


@functools.lru_cache(maxsize=None)
def _carried(ref_cfg, seed):
    from repro.models import lm as ref_lm

    from repro_torch.models import lm

    ref = jax.jit(ref_lm.init_params, static_argnums=0)(
        ref_cfg, jax.random.PRNGKey(seed))
    return ref, lm.params_from_numpy(to_numpy(ref), device="cpu")


def inputs(cfg, B=2, S=32, seed=0):
    """numpy tokens (B, S - prefix_len) int32 and, for a frontend arch,
    prefix embeddings (B, prefix_len, d_model) f32."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S - cfg.prefix_len)).astype(np.int32)
    prefix = None
    if cfg.prefix_len:
        prefix = (0.02 * rng.standard_normal((B, cfg.prefix_len, cfg.d_model))
                  ).astype(np.float32)
    return tokens, prefix


def jnp_or_none(a):
    return None if a is None else jnp.asarray(a)


def t_or_none(a):
    return None if a is None else torch.as_tensor(a)


@functools.lru_cache(maxsize=None)
def ref_fns(cfg):
    """The reference's forward (train), prefill and decode_step, jitted
    once per config."""
    from repro.models import lm as ref_lm

    fwd = jax.jit(lambda p, t, px: ref_lm.forward(p, cfg, t, px, mode="train"))
    pre = jax.jit(lambda p, t, c, px: ref_lm.prefill(p, cfg, t, c, px))
    dec = jax.jit(lambda p, t, c: ref_lm.decode_step(p, cfg, t, c))
    return fwd, pre, dec


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(got, want, label, **tol):
    np.testing.assert_allclose(as_f32(got), as_f32(want), err_msg=label,
                               **(tol or TOL))


def assert_cache_close(got: dict, want: dict, label, **tol):
    """Every cache entry: the same keys, shapes and types, values within
    ``tol`` (int8 entries within one step of the quantiser, f32 values
    that sit on a rounding boundary may round either way)."""
    assert sorted(got) == sorted(want), label
    for key in want:
        w = np.asarray(want[key])
        g = got[key]
        assert tuple(g.shape) == w.shape, (label, key)
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (label, key)
        if w.dtype == np.int8:
            diff = np.abs(g.numpy().astype(np.int32) - w.astype(np.int32))
            assert diff.max() <= 1, (label, key, diff.max())
        else:
            assert_close(g, w, f"{label}: cache[{key!r}]", **tol)
