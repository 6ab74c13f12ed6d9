"""The LM testbed's model: dense / MoE / SSM (Mamba-2) / hybrid (Hymba), a
port of the reference's ``models/lm.py``.

  * Stacked-per-layer parameters, the reference's pytree as a nested dict
    of tensors with a leading layer axis L; the reference's ``lax.scan``
    over layers is a Python loop over those stacks here, each layer under
    ``torch.utils.checkpoint`` in train mode when ``cfg.remat`` is set
    and gradients are being taken (the reference's ``jax.checkpoint``).
  * Three modes share one layer body: "train" (full sequence, no cache),
    "prefill" (full sequence, emits the cache), "decode" (one token).
    KV caches are ring buffers (slot = pos mod capacity): sliding-window
    archs get capacity = window, and the softmax's invariance under a
    permutation of the keys (keys carry their RoPE phase) makes rotation
    bookkeeping unnecessary.
  * MoE dispatch groups: batch rows for train/prefill, the whole batch
    for decode (``moe.py``).
  * Modality frontends (musicgen's EnCodec, internvl's ViT) are stubs:
    callers pass precomputed ``prefix_embeds`` that go ahead of the
    token embeddings.
  * ``decode_step`` is functional as in the reference: it returns a new
    cache dict and leaves its input unchanged.

The reference's sharding calls (``constrain``, ``kv_cache_constraint``,
``_use``'s pin, ``_ffn_block``'s mesh probe) do nothing on one device;
each site below names the reference line, and the sharding slice of the
port brings them.

``LanguageModel`` is the ``nn.Module`` form: it owns the parameters and
exposes ``prefill``/``decode_step`` over the functional API.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ArchConfig, torch_dtype
from repro_torch.core.backend import resolve_device

from . import ssd as ssd_lib
from .layers import (
    apply_rope,
    causal_attention,
    chunked_causal_attention,
    decode_attention,
    decode_attention_deferred,
    dense_init,
    rms_norm,
    swiglu,
)
from .moe import moe_ffn

__all__ = [
    "init_params",
    "forward",
    "init_cache",
    "cache_specs",
    "prefill",
    "decode_step",
    "params_from_numpy",
    "cache_from_numpy",
    "LanguageModel",
]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _has_attn(cfg: ArchConfig) -> bool:
    return cfg.n_heads > 0


def _has_ssm(cfg: ArchConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


def _has_mlp(cfg: ArchConfig) -> bool:
    return cfg.d_ff > 0 and cfg.n_experts == 0


def _conv_dim(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _in_proj_dim(cfg: ArchConfig) -> int:
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """The full parameter tree (stacked layers) on ``device`` (None: the
    card).  Weights are drawn from ``generator`` on its own device (None:
    a CPU generator seeded 0), so one seeded CPU generator gives the
    same parameters on the CPU and on the card."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    pdt = torch_dtype(cfg.param_dtype)
    L, D, F_ = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd, Hq, KV = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    V = cfg.padded_vocab

    def init(shape, scale=None):
        return dense_init(gen, shape, scale, pdt).to(dev)

    def full(shape, value):
        return torch.full(shape, value, dtype=pdt, device=dev)

    p = {
        "embed": init((V, D), scale=0.02),
        "final_norm": full((D,), 1.0),
        "lm_head": init((D, V)),
    }
    layers = {"norm1": full((L, D), 1.0)}
    if _has_attn(cfg):
        attn = {
            "wq": init((L, D, Hq * hd)),
            "wk": init((L, D, KV * hd)),
            "wv": init((L, D, KV * hd)),
            "wo": init((L, Hq * hd, D)),
        }
        if cfg.qkv_bias:
            attn["bq"] = full((L, Hq * hd), 0.0)
            attn["bk"] = full((L, KV * hd), 0.0)
            attn["bv"] = full((L, KV * hd), 0.0)
        layers["attn"] = attn
    if _has_ssm(cfg):
        di, H = cfg.d_inner, cfg.ssm_heads
        W, CD = cfg.ssm_conv_width, _conv_dim(cfg)
        a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
        layers["ssm"] = {
            "in_proj": init((L, D, _in_proj_dim(cfg))),
            "conv_w": init((L, W, CD), scale=0.5),
            "conv_b": full((L, CD), 0.0),
            "A_log": a_log.repeat(L, 1).to(dtype=pdt, device=dev),
            "D": full((L, H), 1.0),
            "dt_bias": full((L, H), -2.0),  # softplus^-1-ish
            "norm": full((L, di), 1.0),
            "out_proj": init((L, di, D)),
        }
    if cfg.family == "hybrid":
        layers["beta_a"] = full((L, D), 1.0)
        layers["beta_m"] = full((L, D), 1.0)
    if cfg.n_experts:
        E = cfg.n_experts
        layers["moe"] = {
            "router": init((L, D, E), scale=0.02),
            "w_gate": init((L, E, D, F_)),
            "w_up": init((L, E, D, F_)),
            "w_down": init((L, E, F_, D)),
        }
        if cfg.moe_dense_residual:
            layers["res"] = {
                "w_gate": init((L, D, F_)),
                "w_up": init((L, D, F_)),
                "w_down": init((L, F_, D)),
            }
    if _has_mlp(cfg):
        layers["mlp"] = {
            "w_gate": init((L, D, F_)),
            "w_up": init((L, D, F_)),
            "w_down": init((L, F_, D)),
        }
    if _has_mlp(cfg) or cfg.n_experts:
        layers["norm2"] = full((L, D), 1.0)
    p["layers"] = layers
    return p


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _kv_capacity(cfg: ArchConfig, max_len: int) -> int:
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def _kv_quantize(x):
    """(..., hd) -> int8 values + a per-vector f32 scale."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    """The decode cache as {name: (shape, torch.dtype)}."""
    adt = torch_dtype(cfg.activation_dtype)
    L, hd, KV = cfg.n_layers, cfg.head_dim_, cfg.n_kv_heads
    c = {"pos": ((), torch.int32)}
    if _has_attn(cfg):
        Sc = _kv_capacity(cfg, max_len)
        int8 = cfg.kv_cache_dtype == "int8"
        kv_dt = torch.int8 if int8 else adt
        c["k"] = ((L, batch, Sc, KV, hd), kv_dt)
        c["v"] = ((L, batch, Sc, KV, hd), kv_dt)
        if int8:  # per-(token, head) scales
            c["k_scale"] = ((L, batch, Sc, KV), torch.float32)
            c["v_scale"] = ((L, batch, Sc, KV), torch.float32)
    if _has_ssm(cfg):
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        c["ssm"] = ((L, batch, H, P, N), torch.float32)
        c["conv"] = ((L, batch, cfg.ssm_conv_width - 1, _conv_dim(cfg)), adt)
    return c


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None) -> dict:
    """A zero decode cache on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return {
        k: torch.zeros(shape, dtype=dt, device=dev)
        for k, (shape, dt) in cache_specs(cfg, batch, max_len).items()
    }


def _to_tensor(a, device) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor of the same type on
    ``device``; types numpy lacks (bf16) go through float32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' type: torch cannot read it
        return torch.from_numpy(np.asarray(a, np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: dict, device=None) -> dict:
    """The reference's parameter pytree, as nested dicts of numpy arrays
    (same keys, same stacked shapes), as the port's tensors on
    ``device`` (None: the card)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)


def cache_from_numpy(tree: dict, device=None) -> dict:
    """The reference's decode cache (a dict of numpy arrays) as the
    port's tensors on ``device`` (None: the card); ``pos`` is a 0-d
    int32 tensor."""
    dev = resolve_device(device)
    return {k: _to_tensor(v, dev) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

# The reference's ``_use`` (src/repro/models/lm.py:209-217) pins a weight to its
# tensor-parallel sharding at the use site when ``zero3_gather_at_use`` is
# set; on one device it is the identity, so the port reads the weight as
# it is (sharding slice).


def _attn_block(lp, x, cfg: ArchConfig, rope, mode, kv_cache, pos):
    """Returns (out (B,T,D), new kv cache tuple)."""
    B, T, D = x.shape
    hd, Hq, KV = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    cos, sin = rope

    q = torch.einsum("btd,dh->bth", x, lp["wq"].to(x.dtype))
    k = torch.einsum("btd,dh->bth", x, lp["wk"].to(x.dtype))
    v = torch.einsum("btd,dh->bth", x, lp["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + lp["bq"].to(x.dtype)
        k = k + lp["bk"].to(x.dtype)
        v = v + lp["bv"].to(x.dtype)
    q = q.reshape(B, T, Hq, hd)
    k = k.reshape(B, T, KV, hd)
    v = v.reshape(B, T, KV, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    int8 = cfg.kv_cache_dtype == "int8"
    new_cache = kv_cache
    if mode == "decode" and cfg.decode_deferred_write:
        # the reference pins the cache's sharding here
        # (kv_cache_constraint, src/repro/models/lm.py:248-252): sharding slice
        k_c, v_c = kv_cache[0], kv_cache[1]  # read-only in the layer loop
        out = decode_attention_deferred(
            q, k_c, v_c, k, v, pos,
            k_scale=kv_cache[2] if int8 else None,
            v_scale=kv_cache[3] if int8 else None,
        )
        # slot values only; written after the layer loop
        if int8:
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            new_cache = (kq, vq, ks, vs)
        else:
            new_cache = (k.to(kv_cache[0].dtype), v.to(kv_cache[1].dtype))
    elif mode == "decode":
        if int8:
            raise NotImplementedError(
                "int8 KV cache requires decode_deferred_write=True"
            )
        k_c, v_c = kv_cache  # (B, Sc, KV, hd)
        Sc = k_c.shape[1]
        slot = pos % Sc
        if cfg.decode_ring_write:
            # masked ring write (the reference's choice for a cache
            # sharded over its sequence axis)
            sel = (torch.arange(Sc, device=x.device) == slot)[None, :, None, None]
            k_c = torch.where(sel, k.to(k_c.dtype), k_c)
            v_c = torch.where(sel, v.to(v_c.dtype), v_c)
        else:  # the reference's dynamic_update_slice at the slot
            idx = slot.reshape(1).long()
            k_c = k_c.index_copy(1, idx, k.to(k_c.dtype))
            v_c = v_c.index_copy(1, idx, v.to(v_c.dtype))
        # the reference pins the cache's sharding through the attention
        # einsums here (src/repro/models/lm.py:295-296): sharding slice
        out = decode_attention(q, k_c, v_c, cache_len=torch.clamp(pos + 1, max=Sc))
        new_cache = (k_c, v_c)
    else:
        if T <= cfg.dense_attn_max:
            out = causal_attention(q, k, v, cfg.sliding_window)
        else:
            out = chunked_causal_attention(
                q, k, v,
                chunk=cfg.attn_chunk,
                sliding_window=cfg.sliding_window,
                causal_skip=cfg.causal_skip,
            )
        if mode == "prefill":
            Sc = kv_cache[0].shape[1]
            take = min(T, Sc)
            k_last, v_last = k[:, -take:], v[:, -take:]
            if take < Sc:  # right-pad into capacity
                padw = (0, 0, 0, 0, 0, Sc - take)
                k_last = F.pad(k_last, padw)
                v_last = F.pad(v_last, padw)
            else:  # ring alignment: slot = position mod Sc
                shift = T % Sc
                k_last = torch.roll(k_last, shift, dims=1)
                v_last = torch.roll(v_last, shift, dims=1)
            if int8:  # quantized cache with per-token scales
                kq, ks = _kv_quantize(k_last)
                vq, vs = _kv_quantize(v_last)
                new_cache = (kq, vq, ks, vs)
            else:
                new_cache = (k_last.to(kv_cache[0].dtype),
                             v_last.to(kv_cache[1].dtype))

    out = out.reshape(B, T, Hq * hd)
    return torch.einsum("bth,hd->btd", out, lp["wo"].to(x.dtype)), new_cache


def _ssm_block(lp, x, cfg: ArchConfig, mode, ssm_cache):
    """Mamba-2 block.  Returns (out (B,T,D), new ssm cache tuple)."""
    B, T, D = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    G, N, W = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv_width

    zxbcdt = torch.einsum("btd,de->bte", x, lp["in_proj"].to(x.dtype))
    z, xin, Bc, Cc, dt = torch.split(zxbcdt, [di, di, G * N, G * N, H], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)  # (B, T, CD)

    A = -torch.exp(lp["A_log"].float())  # (H,)
    dt = F.softplus(dt.float() + lp["dt_bias"].float())  # (B, T, H)

    new_cache = ssm_cache
    if mode == "decode":
        h, conv_c = ssm_cache  # (B,H,P,N) f32, (B,W-1,CD)
        win = torch.cat([conv_c, conv_in], dim=1)  # (B, W, CD)
        conv_out = torch.einsum(
            "bwc,wc->bc", win.float(), lp["conv_w"].float()
        ) + lp["conv_b"].float()
        u = F.silu(conv_out).to(x.dtype)  # (B, CD)
        xs, Bs, Cs = torch.split(u, [di, G * N, G * N], dim=-1)
        h, y = ssd_lib.ssd_decode_step(
            h,
            xs.reshape(B, H, P),
            dt[:, 0],
            A,
            Bs.reshape(B, G, N),
            Cs.reshape(B, G, N),
            lp["D"].float(),
        )
        y = y.reshape(B, 1, di)
        new_cache = (h, win[:, 1:].to(conv_c.dtype))
    else:
        u = F.silu(ssd_lib.causal_conv1d(
            conv_in, lp["conv_w"].float(), lp["conv_b"].float()))
        xs, Bs, Cs = torch.split(u, [di, G * N, G * N], dim=-1)
        y, h_last = ssd_lib.ssd_chunked(
            xs.reshape(B, T, H, P),
            dt,
            A,
            Bs.reshape(B, T, G, N),
            Cs.reshape(B, T, G, N),
            lp["D"].float(),
            chunk=min(cfg.ssm_chunk, T),
            return_state=True,
        )
        y = y.reshape(B, T, di)
        if mode == "prefill":
            conv_c = ssm_cache[1]
            tail = conv_in[:, -(W - 1):]
            if T < W - 1:
                tail = torch.cat([conv_c[:, T:], conv_in], dim=1)
            new_cache = (h_last, tail.to(conv_c.dtype))

    y = y * F.silu(z.float()).to(y.dtype)  # gate
    y = rms_norm(y, lp["norm"], cfg.norm_eps)
    return torch.einsum("bte,ed->btd", y, lp["out_proj"].to(x.dtype)), new_cache


def _ffn_block(lp, x, cfg: ArchConfig, mode):
    """MLP / MoE (+ Arctic's dense residual).  Returns (out, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_experts:
        # the reference probes its mesh here to shard the experts over
        # "model" (EP) or their FFN dims (TP) (src/repro/models/lm.py:434);
        # on one device neither applies: sharding slice
        moe = lp["moe"]
        mp = {name: moe[name].to(x.dtype)
              for name in ("router", "w_gate", "w_up", "w_down")}
        if mode == "decode":
            B = x.shape[0]
            xg = x.reshape(1, B, x.shape[-1])
            out, metrics = moe_ffn(
                xg, mp, cfg.experts_per_token,
                capacity_factor=max(2.0, cfg.capacity_factor),
            )
            out = out.reshape(B, 1, x.shape[-1])
        else:
            out, metrics = moe_ffn(x, mp, cfg.experts_per_token, cfg.capacity_factor)
        aux = metrics.aux_loss + 1e-3 * metrics.z_loss
        if cfg.moe_dense_residual:
            rp = lp["res"]
            out = out + swiglu(x, rp["w_gate"].to(x.dtype), rp["w_up"].to(x.dtype),
                               rp["w_down"].to(x.dtype))
        return out, aux
    mp = lp["mlp"]
    return (
        swiglu(x, mp["w_gate"].to(x.dtype), mp["w_up"].to(x.dtype),
               mp["w_down"].to(x.dtype)),
        aux,
    )


def _layer_body(lp, x, cfg: ArchConfig, rope, mode, cache_l, pos):
    """One layer.  ``cache_l`` is a dict of this layer's cache slices
    (empty in train mode); returns (x, new slices, aux)."""
    new_cache = {}
    u = rms_norm(x, lp["norm1"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    int8 = cfg.kv_cache_dtype == "int8"

    def kv_in():
        if mode == "train":
            return None
        base = (cache_l["k"], cache_l["v"])
        if int8:
            base += (cache_l["k_scale"], cache_l["v_scale"])
        return base

    def kv_out(kv):
        if mode == "train":
            return
        new_cache["k"], new_cache["v"] = kv[0], kv[1]
        if int8:
            new_cache["k_scale"], new_cache["v_scale"] = kv[2], kv[3]

    def ssm_in():
        return None if mode == "train" else (cache_l["ssm"], cache_l["conv"])

    def ssm_out(sc):
        if mode != "train":
            new_cache["ssm"], new_cache["conv"] = sc

    if cfg.family == "hybrid":
        a, kv = _attn_block(lp["attn"], u, cfg, rope, mode, kv_in(), pos)
        s, sc = _ssm_block(lp["ssm"], u, cfg, mode, ssm_in())
        mix = 0.5 * (a * lp["beta_a"].to(x.dtype) + s * lp["beta_m"].to(x.dtype))
        x = x + mix
        kv_out(kv)
        ssm_out(sc)
    elif cfg.family == "ssm":
        s, sc = _ssm_block(lp["ssm"], u, cfg, mode, ssm_in())
        x = x + s
        ssm_out(sc)
    else:
        a, kv = _attn_block(lp["attn"], u, cfg, rope, mode, kv_in(), pos)
        x = x + a
        kv_out(kv)

    if _has_mlp(cfg) or cfg.n_experts:
        h = rms_norm(x, lp["norm2"], cfg.norm_eps)
        f, aux = _ffn_block(lp, h, cfg, mode)
        x = x + f
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _rope_tables(cfg: ArchConfig, positions: torch.Tensor):
    """cos and sin of f32 ``positions x inv_freq``, built as the
    reference builds them (no complex numbers)."""
    hd = cfg.head_dim_
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=positions.device) / hd
    inv = 1.0 / (cfg.rope_theta ** exps)
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def _layer_slices(tree) -> list:
    """The stacked layer tree as one tree of views a layer, one ``unbind``
    per leaf: its backward stacks the layers' gradients once, where
    indexing each layer would scatter each into a zero tensor of the
    whole stack."""
    if not isinstance(tree, dict):
        return list(torch.unbind(tree, 0))
    per_key = {k: _layer_slices(v) for k, v in tree.items()}
    return [dict(zip(per_key, layer)) for layer in zip(*per_key.values())]


def _stack(params, cfg, x, rope, mode, cache, pos):
    """Loop over the stacked layers (the reference's ``lax.scan``); cache
    tensors have leading dim L.  Returns (x, new cache, aux).

    In train mode with ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of the
    scan body, src/repro/models/lm.py:564-565): only the layer's inputs
    are kept for the backward, which recomputes the layer.  It changes
    no value."""
    layer_keys = [k for k in cache if k != "pos"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    outs = {k: [] for k in layer_keys}
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    for l, lp in enumerate(_layer_slices(params["layers"])):
        cache_l = {k: cache[k][l] for k in layer_keys}
        if remat:
            x, new_l, a = torch.utils.checkpoint.checkpoint(
                _layer_body, lp, x, cfg, rope, mode, cache_l, pos,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, new_l, a = _layer_body(lp, x, cfg, rope, mode, cache_l, pos)
        # train mode with seq_parallel: the reference shards the residual
        # stream's sequence axis between layers (constrain,
        # src/repro/models/lm.py:548-561): sharding slice
        aux = aux + a
        for k in layer_keys:
            outs[k].append(new_l[k])
    new_cache = dict(cache)
    for k in layer_keys:
        new_cache[k] = torch.stack(outs[k])
    return x, new_cache, aux


def _embed_inputs(params, cfg, tokens, prefix_embeds, adt):
    h = params["embed"][tokens].to(adt)
    if cfg.prefix_len:
        if prefix_embeds is None:
            raise ValueError(
                f"{cfg.name} has a {cfg.frontend} frontend stub: pass "
                "prefix_embeds (B, prefix_len, d_model)"
            )
        h = torch.cat([prefix_embeds.to(adt), h], dim=1)
    return h


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None, mode: str = "train",
            cache: Optional[dict] = None):
    """Full-sequence forward.  Returns (logits, aux_loss) for train, or
    (last_logits (B, V) f32, cache) for prefill."""
    adt = torch_dtype(cfg.activation_dtype)
    h = _embed_inputs(params, cfg, tokens, prefix_embeds, adt)
    # the reference constrains h's batch axis here
    # (src/repro/models/lm.py:599-603) and the logits' vocab axis
    # (:626): sharding slice
    B, S, _ = h.shape
    rope = (_rope_tables(cfg, torch.arange(S, device=h.device))
            if _has_attn(cfg) else None)

    if mode == "prefill":
        if cache is None:
            raise ValueError("prefill needs a cache (init_cache)")
    else:
        cache = {}  # the reference scans a dummy cache it drops

    h, new_cache, aux = _stack(params, cfg, h, rope, mode, cache, pos=0)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)

    if mode == "prefill":
        new_cache["pos"] = torch.tensor(S, dtype=torch.int32, device=h.device)
        last = torch.einsum("bd,dv->bv", h[:, -1], params["lm_head"].to(adt))
        return last.float(), new_cache

    logits = torch.einsum("btd,dv->btv", h, params["lm_head"].to(adt))
    return logits, aux


def prefill(params, cfg: ArchConfig, tokens, cache, prefix_embeds=None):
    return forward(params, cfg, tokens, prefix_embeds, mode="prefill", cache=cache)


def decode_step(params, cfg: ArchConfig, tokens, cache):
    """One decoding step.  tokens: (B, 1).  Returns (logits (B,V) f32,
    a new cache); ``cache`` is left as it was."""
    adt = torch_dtype(cfg.activation_dtype)
    h = params["embed"][tokens].to(adt)
    pos = cache["pos"]
    rope = _rope_tables(cfg, pos[None].float()) if _has_attn(cfg) else None
    h, new_cache, _ = _stack(params, cfg, h, rope, "decode", cache, pos=pos)
    if _has_attn(cfg) and cfg.decode_deferred_write:
        # one masked ring write of the whole stacked cache per step: the
        # layer loop only emitted the slot values (L, B, 1, KV[, hd])
        Sc = cache["k"].shape[2]
        slot = pos % Sc
        sel = (torch.arange(Sc, device=h.device) == slot)[None, None, :, None, None]
        keys = ["k", "v"]
        if cfg.kv_cache_dtype == "int8":
            keys += ["k_scale", "v_scale"]
        for key in keys:
            slot_vals = new_cache[key]
            s = sel if slot_vals.dim() == 5 else sel[..., 0]
            new_cache[key] = torch.where(s, slot_vals.to(cache[key].dtype), cache[key])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bd,dv->bv", h[:, 0], params["lm_head"].to(adt))
    new_cache["pos"] = pos + 1
    return logits.float(), new_cache


# ---------------------------------------------------------------------------
# module form
# ---------------------------------------------------------------------------

_SEP = "__"  # nested keys joined into parameter names


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{_SEP}{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, name)
        else:
            yield name, v


class LanguageModel(nn.Module):
    """The parameters of one ``ArchConfig`` as an ``nn.Module`` (one
    parameter per leaf of the reference's tree, named by its path joined
    with ``__``), with the functional entry points as methods.

    The weights are frozen (``requires_grad=False``) for serving.  To
    train through the module form, ``model.requires_grad_(True)`` makes
    every weight a leaf of the autograd graph: ``model(tokens)`` then
    takes gradients into each weight's ``.grad``.  The training slice's
    own step (``train.step``) works on the functional tree instead."""

    def __init__(self, cfg: ArchConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict({
            name: nn.Parameter(t, requires_grad=False)
            for name, t in _flatten(params)
        })

    @classmethod
    def init(cls, cfg: ArchConfig, generator: Optional[torch.Generator] = None,
             device=None) -> "LanguageModel":
        return cls(cfg, init_params(cfg, generator, device))

    @property
    def params(self) -> dict:
        """The nested parameter tree the functional API takes."""
        tree: dict = {}
        for name, t in self.weights.items():
            *path, leaf = name.split(_SEP)
            node = tree
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = t
        return tree

    @property
    def device(self) -> torch.device:
        return self.weights["embed"].device

    def init_cache(self, batch: int, max_len: int) -> dict:
        return init_cache(self.cfg, batch, max_len, self.device)

    def forward(self, tokens, prefix_embeds=None):
        """Train-mode logits (B, T, V) and the MoE aux loss."""
        return forward(self.params, self.cfg, tokens, prefix_embeds)

    def prefill(self, tokens, cache, prefix_embeds=None):
        return prefill(self.params, self.cfg, tokens, cache, prefix_embeds)

    def decode_step(self, tokens, cache):
        return decode_step(self.params, self.cfg, tokens, cache)
