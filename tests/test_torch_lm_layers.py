"""The LM testbed's layers (``repro_torch.models.layers``, ``ssd``,
``moe``) against the reference's on the CPU, in f32 on the same
numpy-seeded inputs, at rtol = atol = 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, label="", **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=label,
                               **(tol or TOL))


def _qkv(seed, B=2, T=64, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    return _rand(rng, B, T, H, hd), _rand(rng, B, T, KV, hd), _rand(rng, B, T, KV, hd)


def test_rms_norm_and_rope():
    from repro.models import layers as ref

    from repro_torch.models import layers

    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 8, 4, 32), _rand(rng, 32)
    _close(layers.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-5),
           ref.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), "rms_norm")
    cos, sin = layers.rope_freqs(32, 8, device="cpu")
    rcos, rsin = ref.rope_freqs(32, 8)
    _close(cos, rcos, "cos")
    _close(sin, rsin, "sin")
    _close(layers.apply_rope(torch.as_tensor(x), cos, sin),
           ref.apply_rope(jnp.asarray(x), rcos, rsin), "apply_rope")
    k = _rand(rng, 2, 8, 2, 16)
    _close(layers._repeat_kv(torch.as_tensor(k), 3), ref._repeat_kv(jnp.asarray(k), 3))


@pytest.mark.parametrize("window", [0, 24])
def test_causal_attention(window):
    from repro.models import layers as ref

    from repro_torch.models import layers

    q, k, v = _qkv(1)
    _close(layers.causal_attention(*map(torch.as_tensor, (q, k, v)), window),
           ref.causal_attention(*map(jnp.asarray, (q, k, v)), window))


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("skip", [False, True], ids=["all_pairs", "causal_skip"])
def test_chunked_causal_attention(skip, window):
    from repro.models import layers as ref

    from repro_torch.models import layers

    q, k, v = _qkv(2, T=64)
    got = layers.chunked_causal_attention(*map(torch.as_tensor, (q, k, v)), chunk=16,
                                          sliding_window=window, causal_skip=skip)
    _close(got, ref.chunked_causal_attention(*map(jnp.asarray, (q, k, v)), chunk=16,
                                             sliding_window=window, causal_skip=skip))
    # and both schedules are the dense attention
    _close(got, layers.causal_attention(*map(torch.as_tensor, (q, k, v)), window))
    with pytest.raises(ValueError, match="not divisible"):
        layers.chunked_causal_attention(*map(torch.as_tensor, (q, k, v)), chunk=24)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention(window):
    from repro.models import layers as ref

    from repro_torch.models import layers

    rng = np.random.default_rng(3)
    q, kc, vc = _rand(rng, 3, 1, 4, 16), _rand(rng, 3, 20, 2, 16), _rand(rng, 3, 20, 2, 16)
    lens = np.array([1, 12, 20], np.int32)
    for cl in (lens, 7):
        _close(layers.decode_attention(*map(torch.as_tensor, (q, kc, vc)),
                                       torch.as_tensor(cl), window),
               ref.decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(cl),
                                    window), f"cache_len={cl}")


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("pos", [0, 5, 16, 23, 40])
def test_decode_attention_deferred(pos, int8):
    """Capacity 16: positions before, at and past it (the wrapped slot
    masked), with and without a window, and the int8 cache's scales."""
    from repro.models import layers as ref
    from repro.models.lm import _kv_quantize as ref_quant

    from repro_torch.models import layers
    from repro_torch.models.lm import _kv_quantize

    rng = np.random.default_rng(pos)
    q = _rand(rng, 2, 1, 4, 16)
    kc, vc = _rand(rng, 2, 16, 2, 16), _rand(rng, 2, 16, 2, 16)
    ks, vs = _rand(rng, 2, 1, 2, 16), _rand(rng, 2, 1, 2, 16)
    t = dict(q=q, kc=kc, vc=vc, ks=ks, vs=vs)
    scales = {}
    if int8:
        kq, kscale = ref_quant(jnp.asarray(kc))
        vq, vscale = ref_quant(jnp.asarray(vc))
        gkq, gks = _kv_quantize(torch.as_tensor(kc))
        np.testing.assert_array_equal(gkq.numpy(), np.asarray(kq))
        _close(gks, kscale, "k_scale")
        t.update(kc=np.array(kq), vc=np.array(vq))
        scales = dict(k_scale=np.array(kscale), v_scale=np.array(vscale))
    for window in (0, 6):
        want = jax.jit(ref.decode_attention_deferred, static_argnums=6)(
            *(jnp.asarray(t[n]) for n in ("q", "kc", "vc", "ks", "vs")), pos, window,
            **{n: jnp.asarray(a) for n, a in scales.items()})
        got = layers.decode_attention_deferred(
            *(torch.as_tensor(t[n]) for n in ("q", "kc", "vc", "ks", "vs")),
            torch.tensor(pos, dtype=torch.int32), window,
            **{n: torch.as_tensor(a) for n, a in scales.items()})
        _close(got, want, f"window={window}")


def _ssd_inputs(seed, B=2, L=32, H=4, P=8, G=2, N=16):
    rng = np.random.default_rng(seed)
    x = _rand(rng, B, L, H, P)
    dt = np.log1p(np.exp(_rand(rng, B, L, H) - 1.0)).astype(np.float32)
    A = -np.exp(_rand(rng, H, scale=0.5)).astype(np.float32)
    Bm, Cm = _rand(rng, B, L, G, N), _rand(rng, B, L, G, N)
    D = _rand(rng, H)
    return x, dt, A, Bm, Cm, D


def test_ssd_reference_and_chunked():
    from repro.models import ssd as ref

    from repro_torch.models import ssd

    args = _ssd_inputs(4)
    j, t = [jnp.asarray(a) for a in args], [torch.as_tensor(a) for a in args]
    want = jax.jit(ref.ssd_reference)(*j)
    _close(ssd.ssd_reference(*t), want, "ssd_reference")
    y, h = ssd.ssd_chunked(*t, chunk=8, return_state=True)
    wy, wh = jax.jit(ref.ssd_chunked, static_argnames=("chunk", "return_state"))(
        *j, chunk=8, return_state=True)
    _close(y, wy, "ssd_chunked y")
    _close(h, wh, "ssd_chunked state")
    assert tuple(h.shape) == (2, 4, 8, 16)  # (B, H, P, N)
    _close(y, want, "chunked == recurrence", rtol=1e-4, atol=1e-4)
    _close(ssd.ssd_chunked(*t[:5], chunk=16), jax.jit(ref.ssd_chunked, static_argnames="chunk")(*j[:5], chunk=16),
           "no D")
    with pytest.raises(ValueError, match="not divisible"):
        ssd.ssd_chunked(*t, chunk=12)


def test_ssd_decode_step_continues_the_chunked_state():
    from repro.models import ssd as ref

    from repro_torch.models import ssd

    x, dt, A, Bm, Cm, D = _ssd_inputs(5, L=17)
    t = [torch.as_tensor(a) for a in (x, dt, A, Bm, Cm, D)]
    _, h = ssd.ssd_chunked(t[0][:, :16], t[1][:, :16], t[2], t[3][:, :16],
                           t[4][:, :16], t[5], chunk=8, return_state=True)
    step = (x[:, 16], dt[:, 16], A, Bm[:, 16], Cm[:, 16], D)
    got_h, got_y = ssd.ssd_decode_step(h, *map(torch.as_tensor, step))
    want_h, want_y = ref.ssd_decode_step(jnp.asarray(h.numpy()), *map(jnp.asarray, step))
    _close(got_h, want_h, "state")
    _close(got_y, want_y, "y")
    full = ssd.ssd_reference(*t)
    _close(got_y, full[:, 16], "== the recurrence's step 16", rtol=1e-4, atol=1e-4)


def test_causal_conv1d():
    from repro.models import ssd as ref

    from repro_torch.models import ssd

    rng = np.random.default_rng(6)
    u, w, b = _rand(rng, 2, 9, 12), _rand(rng, 4, 12), _rand(rng, 12)
    _close(ssd.causal_conv1d(*map(torch.as_tensor, (u, w, b))),
           ref.causal_conv1d(*map(jnp.asarray, (u, w, b))))
    _close(ssd.causal_conv1d(*map(torch.as_tensor, (u, w))),
           ref.causal_conv1d(*map(jnp.asarray, (u, w))))


def _moe_params(rng, D=16, E=4, F=24):
    return {"router": _rand(rng, D, E, scale=0.5), "w_gate": _rand(rng, E, D, F, scale=0.2),
            "w_up": _rand(rng, E, D, F, scale=0.2), "w_down": _rand(rng, E, F, D, scale=0.2)}


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5], ids=["roomy", "default", "dropping"])
def test_moe_ffn(cf):
    from repro.models import moe as ref

    from repro_torch.models import moe

    rng = np.random.default_rng(7)
    x, p = _rand(rng, 3, 10, 16), _moe_params(rng)
    got, gm = moe.moe_ffn(torch.as_tensor(x), {k: torch.as_tensor(v) for k, v in p.items()},
                          2, cf)
    want, wm = jax.jit(ref.moe_ffn, static_argnums=(2, 3))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, 2, cf)
    _close(got, want, "out")
    for name, g, w in zip(wm._fields, gm, wm):
        _close(g, w, name)
    if cf == 0.5:
        assert float(gm.drop_frac) > 0


def test_router_ties_break_to_the_lower_index():
    """Exactly tied router probabilities (a zero router: every expert at
    1/E; duplicated expert columns): the top-k ids, the capacity order
    and the output are the reference's."""
    from repro.models import moe as ref

    from repro_torch.models import moe

    rng = np.random.default_rng(8)
    x, p = _rand(rng, 2, 12, 16), _moe_params(rng, E=6)
    first_ids = []
    for router in (np.zeros((16, 6), np.float32),
                   np.repeat(p["router"][:, :2], 3, axis=1)):
        p["router"] = router
        _, _, gp, gi = moe.router_topk(torch.as_tensor(x), torch.as_tensor(router), 3)
        _, _, wp, wi = ref.router_topk(jnp.asarray(x), jnp.asarray(router), 3)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        first_ids.append(gi[0, 0].tolist())
        _close(gp, wp, "top_p")
        got, gm = moe.moe_ffn(torch.as_tensor(x),
                              {k: torch.as_tensor(v) for k, v in p.items()}, 2, 1.0)
        want, wm = jax.jit(ref.moe_ffn, static_argnums=(2, 3))(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, 2, 1.0)
        _close(got, want, "out")
        _close(gm.drop_frac, wm.drop_frac, "drop_frac")
    assert gi.dtype == torch.int32
    # all six tied: the lowest three ids; three tied pairs of columns: the
    # leading column of each tie first
    assert first_ids[0] == [0, 1, 2]
    assert first_ids[1] in ([0, 1, 2], [3, 4, 5])


def test_swiglu_and_dense_init():
    from repro.models import layers as ref

    from repro_torch.models import layers

    rng = np.random.default_rng(9)
    x, wg, wu, wd = _rand(rng, 2, 5, 8), _rand(rng, 8, 12), _rand(rng, 8, 12), _rand(rng, 12, 8)
    _close(layers.swiglu(*map(torch.as_tensor, (x, wg, wu, wd))),
           ref.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    w = layers.dense_init(torch.Generator().manual_seed(0), (3, 400, 300))
    assert w.dtype == torch.float32 and tuple(w.shape) == (3, 400, 300)
    assert abs(float(w.std()) - 1 / 400 ** 0.5) < 1e-3
    again = layers.dense_init(torch.Generator().manual_seed(0), (3, 400, 300))
    assert torch.equal(w, again)
