"""The LM testbed's model, ``repro_torch.models.lm``, against the
reference's ``repro.models.lm`` on the CPU, for all ten smoke configs.

The reference's parameters are carried across with ``params_from_numpy``
and both sides take the same numpy tokens.  At f32 activations logits
and every cache entry are held to rtol = atol = 1e-4 (f32 sums in
another order).  At the default bf16 activations the dense, SSM and
hybrid archs are held within atol 0.1 on logits: bf16 rounds at other
places in the two frameworks, and bf16 against f32 inside one package
differs by 0.05-0.09 at these configs.  The MoE archs are held in bf16
at the ``moe_ffn`` level only, on identical inputs: end to end a
one-ulp difference between the packages can flip a top-2 routing
decision.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_lm import (
    ARCHS,
    MOE_ARCHS,
    assert_cache_close,
    assert_close,
    carried_params,
    inputs,
    jnp_or_none,
    ref_fns,
    smoke,
    t_or_none,
    to_numpy,
)

N_DEC = 4


def _prefill_decode(ref_cfg, cfg, B=2, S=32, max_len=None, seed=0,
                    cache_tol=None, logit_tol=None):
    """Prefill B x S positions, then N_DEC teacher-forced decode steps, on
    both sides; logits and the whole cache held after every call."""
    from repro.models import lm as ref_lm

    from repro_torch.models import lm

    ref_p, p = carried_params(ref_cfg, seed)
    tokens, prefix = inputs(cfg, B, S + N_DEC, seed)
    feed = tokens[:, -N_DEC:]
    tokens = tokens[:, :-N_DEC]
    max_len = max_len or S + 8
    _, pre, dec = ref_fns(ref_cfg)
    want_l, want_c = pre(ref_p, jnp.asarray(tokens), ref_lm.init_cache(ref_cfg, B, max_len),
                         jnp_or_none(prefix))
    got_l, got_c = lm.prefill(p, cfg, torch.as_tensor(tokens),
                              lm.init_cache(cfg, B, max_len, device="cpu"),
                              t_or_none(prefix))
    tol = logit_tol or {}
    assert_close(got_l, want_l, "prefill logits", **tol)
    assert_cache_close(got_c, to_numpy(want_c), "prefill", **(cache_tol or tol))
    for i in range(N_DEC):
        t = feed[:, i:i + 1]
        want_l, want_c = dec(ref_p, jnp.asarray(t), want_c)
        before = {k: v.clone() for k, v in got_c.items()}
        got_l, new_c = lm.decode_step(p, cfg, torch.as_tensor(t), got_c)
        for k in before:  # functional: the input cache is left as it was
            assert torch.equal(before[k], got_c[k]), k
        got_c = new_c
        assert_close(got_l, want_l, f"decode {i} logits", **tol)
        assert_cache_close(got_c, to_numpy(want_c), f"decode {i}", **(cache_tol or tol))
    return got_l


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    from repro_torch.models import lm

    ref_cfg, cfg = smoke(arch, activation_dtype="float32")
    ref_p, p = carried_params(ref_cfg)
    tokens, prefix = inputs(cfg)
    fwd, _, _ = ref_fns(ref_cfg)
    want, want_aux = fwd(ref_p, jnp.asarray(tokens), jnp_or_none(prefix))
    got, aux = lm.forward(p, cfg, torch.as_tensor(tokens), t_or_none(prefix))
    assert got.shape == (2, 32, cfg.padded_vocab) and got.dtype == torch.float32
    assert_close(got, want, "train logits")
    assert_close(aux, want_aux, "aux loss")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    ref_cfg, cfg = smoke(arch, activation_dtype="float32")
    _prefill_decode(ref_cfg, cfg)


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen1.5-32b"])
def test_int8_cache_matches_reference(arch):
    ref_cfg, cfg = smoke(arch, activation_dtype="float32", kv_cache_dtype="int8")
    _prefill_decode(ref_cfg, cfg)


def test_int8_cache_needs_the_deferred_write():
    from repro_torch.models import lm

    _, cfg = smoke("glm4-9b", activation_dtype="float32", kv_cache_dtype="int8",
                   decode_deferred_write=False)
    p = lm.init_params(cfg, device="cpu")
    cache = lm.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="decode_deferred_write"):
        lm.decode_step(p, cfg, torch.zeros((2, 1), dtype=torch.int32), cache)


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "update_slice"])
@pytest.mark.parametrize("arch,S,max_len", [
    ("smollm-135m", 32, 40),
    # hymba's window is 64: a prefill of 64 fills the ring (roll), and the
    # decode steps write past its capacity
    ("hymba-1.5b", 64, 72),
])
def test_immediate_cache_write_matches_reference(arch, S, max_len, ring):
    ref_cfg, cfg = smoke(arch, activation_dtype="float32",
                         decode_deferred_write=False, decode_ring_write=ring)
    _prefill_decode(ref_cfg, cfg, S=S, max_len=max_len)


@pytest.mark.parametrize("arch,S,max_len", [
    ("hymba-1.5b", 64, 72),  # deferred write past the window's capacity
    ("mixtral-8x7b", 128, 140),
])
def test_deferred_ring_wraps_as_the_reference(arch, S, max_len):
    ref_cfg, cfg = smoke(arch, activation_dtype="float32")
    _prefill_decode(ref_cfg, cfg, S=S, max_len=max_len)


@pytest.mark.parametrize("skip", [False, True], ids=["all_pairs", "causal_skip"])
def test_chunked_prefill_matches_reference(skip):
    """A prefill past ``dense_attn_max`` (256 at the smoke config) takes
    the chunked attention in both packages."""
    ref_cfg, cfg = smoke("smollm-135m", activation_dtype="float32", causal_skip=skip)
    _prefill_decode(ref_cfg, cfg, B=1, S=320, max_len=328)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE_ARCHS])
def test_bf16_logits_within_atol(arch):
    ref_cfg, cfg = smoke(arch)
    assert cfg.activation_dtype == "bfloat16"
    got = _prefill_decode(ref_cfg, cfg, logit_tol=dict(rtol=0, atol=0.1),
                          cache_tol=dict(rtol=0, atol=0.1))
    assert got.dtype == torch.float32


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_bf16_on_identical_inputs(arch):
    """The MoE archs in bf16: layer 0's expert weights, cast to bf16 as
    ``_ffn_block`` casts them, on the same bf16 activations."""
    from repro.models.moe import moe_ffn as ref_moe

    from repro_torch.models.moe import moe_ffn

    ref_cfg, cfg = smoke(arch)
    ref_p, p = carried_params(ref_cfg)
    x = np.random.default_rng(3).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, wm = jax.jit(ref_moe, static_argnums=(2, 3))(
        jnp.asarray(x, jnp.bfloat16),
        {k: v[0].astype(jnp.bfloat16) for k, v in ref_p["layers"]["moe"].items()},
        cfg.experts_per_token, cfg.capacity_factor,
    )
    got, gm = moe_ffn(
        torch.as_tensor(x).to(torch.bfloat16),
        {k: v[0].to(torch.bfloat16) for k, v in p["layers"]["moe"].items()},
        cfg.experts_per_token, cfg.capacity_factor,
    )
    assert got.dtype == torch.bfloat16
    assert_close(got, want, "moe out", rtol=0, atol=2e-2)
    for name, g, w in zip(wm._fields, gm, wm):
        assert_close(g, w, name, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """The port's own init: the reference's keys, shapes and dtypes, drawn
    from a CPU generator so that a seed gives the same values anywhere."""
    from repro.models import lm as ref_lm

    from repro_torch.models import lm

    ref_cfg, cfg = smoke(arch)
    want = jax.eval_shape(lambda: ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0)))
    got = lm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat_g[path + (k,)] = v

    walk(got, ())
    assert len(flat_g) == len(flat_w)
    for path, w in flat_w:
        key = tuple(k.key for k in path)
        assert tuple(flat_g[key].shape) == w.shape, key
        assert flat_g[key].dtype == torch.float32, key
    again = lm.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(again["embed"], got["embed"])
    specs = lm.cache_specs(cfg, 2, 16)
    ref_specs = ref_lm.cache_specs(ref_cfg, 2, 16)
    assert {k: s[0] for k, s in specs.items()} == {k: s.shape for k, s in ref_specs.items()}


def test_language_model_module_runs_the_functional_api():
    from repro_torch.models import lm

    _, cfg = smoke("hymba-1.5b", activation_dtype="float32")
    model = lm.LanguageModel.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    p = model.params
    assert set(p["layers"]) >= {"attn", "ssm", "beta_a", "beta_m", "norm1", "norm2"}
    assert sum(t.numel() for t in model.parameters()) == sum(
        t.numel() for _, t in lm._flatten(p))
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(2))
    logits, _ = model(tokens)
    cache = model.init_cache(2, 40)
    last, cache = model.prefill(tokens[:, :-1], cache)
    step, cache = model.decode_step(tokens[:, -1:], cache)
    assert_close(last, logits[:, -2], "prefill vs forward", rtol=1e-3, atol=1e-3)
    assert_close(step, logits[:, -1], "decode vs forward", rtol=1e-3, atol=1e-3)
    assert int(cache["pos"]) == 32


@pytest.mark.parametrize("arch,overrides", [
    ("hymba-1.5b", {}),  # k, v, ssm and conv entries
    ("glm4-9b", {"kv_cache_dtype": "int8"}),  # int8 values and their scales
])
def test_cache_from_numpy_continues_the_reference_decode(arch, overrides):
    """The reference's prefill cache carried into the port decodes as the
    reference goes on decoding."""
    from repro.models import lm as ref_lm

    from repro_torch.models import lm

    ref_cfg, cfg = smoke(arch, activation_dtype="float32", **overrides)
    ref_p, p = carried_params(ref_cfg)
    tokens, prefix = inputs(cfg, B=2, S=33, seed=4)
    _, pre, dec = ref_fns(ref_cfg)
    _, ref_cache = pre(ref_p, jnp.asarray(tokens[:, :-1]),
                       ref_lm.init_cache(ref_cfg, 2, 40), jnp_or_none(prefix))
    cache = lm.cache_from_numpy(to_numpy(ref_cache), device="cpu")
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    want_l, want_c = dec(ref_p, jnp.asarray(tokens[:, -1:]), ref_cache)
    got_l, got_c = lm.decode_step(p, cfg, torch.as_tensor(tokens[:, -1:]), cache)
    assert_close(got_l, want_l, "decode logits")
    assert_cache_close(got_c, to_numpy(want_c), "decode")
