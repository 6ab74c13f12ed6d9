"""Shared neural-net layers of the LM testbed, a port of the reference's
``models/layers.py`` (functional, on stacked-per-layer parameters).

Attention supports:
  * full causal (train / prefill of short sequences);
  * chunked causal with an online softmax (memory-bounded long prefill):
    the baseline visits every (q-chunk, kv-chunk) pair with masking,
    ``causal_skip=True`` only the causal pairs (and, for sliding windows,
    those inside the band);
  * sliding-window (Mixtral, Hymba);
  * single-token decode against a KV cache (GQA layout), and its
    deferred-write form with an optional int8 cache.

The reference's masking (-1e30, softmax in f32) and its grouped-query
einsum order are kept, which is what the parity tests hold, so these are
plain ``torch.einsum`` products and not
``F.scaled_dot_product_attention``.  Large products stay ``torch.einsum``
as the reference left them to XLA: the testbed has no Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.backend import resolve_device

__all__ = [
    "rms_norm",
    "rope_freqs",
    "apply_rope",
    "causal_attention",
    "chunked_causal_attention",
    "decode_attention",
    "decode_attention_deferred",
    "swiglu",
    "dense_init",
]

_NEG = -1e30  # the reference's mask value


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal init drawn from ``generator`` on its own device; scale
    defaults to 1/sqrt(fan_in)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    draw = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return (scale * draw).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMSNorm in f32, cast back to the input dtype (LLaMA convention)."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * scale.float()
    return out.to(dt)


def rope_freqs(head_dim: int, max_len: int, theta: float = 1e4, device=None):
    """(max_len, head_dim/2) cosines and sines of the rotation angles, on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=dev,
                                        dtype=torch.float32) / head_dim))
    t = torch.arange(max_len, device=dev, dtype=torch.float32)
    ang = torch.outer(t, inv)  # (T, hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (..., T, H, hd); cos/sin: (T, hd/2) (already offset for decode)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(dt)


def _repeat_kv(k: torch.Tensor, n_rep: int):
    """(B, T, KV, hd) -> (B, T, KV*n_rep, hd) for GQA (reference only:
    the attention paths use grouped einsums that never expand heads)."""
    if n_rep == 1:
        return k
    b, t, kv, hd = k.shape
    k = k[:, :, :, None, :].expand(b, t, kv, n_rep, hd)
    return k.reshape(b, t, kv * n_rep, hd)


def _group_q(q: torch.Tensor, kv: int):
    """(B, T, H, hd) -> (B, T, KV, G, hd)."""
    b, t, h, hd = q.shape
    return q.reshape(b, t, kv, h // kv, hd)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sliding_window: int = 0):
    """Dense causal attention, grouped-query form (k/v never expanded).
    q: (B, T, H, hd); k, v: (B, T, KV, hd)."""
    b, t, h, hd = q.shape
    qg = _group_q(q, k.shape[2])  # (B, T, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(hd)
    qi = torch.arange(t, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    mask = ki <= qi
    if sliding_window:
        mask &= ki > qi - sliding_window
    scores = torch.where(mask, scores, _NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return out.reshape(b, t, h, hd)


def _pair_update(carry, qi, ki, q_i, k_j, v_j, chunk, scale, sliding_window):
    """Online-softmax update of (m, l, acc) for the query chunks ``qi``
    against key chunk ``ki``.  ``qi`` is a tensor of any leading shape
    N (``q_i`` is (*N, B, chunk, KV, G, hd)): the baseline updates every
    query chunk at once, as the reference's ``vmap`` does.  m and l are
    (*N, B, chunk, KV, G), acc (*N, B, chunk, KV, G, hd), all f32."""
    m, l, acc = carry
    s = torch.einsum("...qkgd,...skd->...kgqs", q_i, k_j).float()
    s = s * scale
    pos = torch.arange(chunk, device=q_i.device)
    qpos = qi[..., None, None] * chunk + pos[:, None]  # (*N, c, 1)
    kpos = ki * chunk + pos[None, :]
    mask = kpos <= qpos
    if sliding_window:
        mask &= kpos > qpos - sliding_window
    mask = mask[..., None, None, None, :, :]  # (*N, 1, 1, 1, c, c)
    s = torch.where(mask, s, _NEG)
    # s: (*N, B, KV, G, chunk_q, chunk_k)
    s_max = s.amax(dim=-1).movedim(-1, -3)  # (*N, B, chunk_q, KV, G)
    m_new = torch.maximum(m, s_max)
    p = torch.exp(s - m_new.movedim(-3, -1)[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1).movedim(-1, -3)
    upd = torch.einsum("...kgqs,...skd->...qkgd", p.to(q_i.dtype), v_j).float()
    acc_new = acc * corr[..., None] + upd
    return m_new, l_new, acc_new


def _init_carry(lead, b, chunk, kv, g, hd, device):
    m = torch.full((*lead, b, chunk, kv, g), _NEG, dtype=torch.float32, device=device)
    l = torch.zeros((*lead, b, chunk, kv, g), dtype=torch.float32, device=device)
    acc = torch.zeros((*lead, b, chunk, kv, g, hd), dtype=torch.float32, device=device)
    return m, l, acc


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             chunk: int = 512, sliding_window: int = 0,
                             causal_skip: bool = False):
    """Flash-style chunked attention with an online softmax.

    ``causal_skip=False`` (baseline): every (qc, kc) chunk pair is
    computed and masked (about twice the useful FLOPs); all query chunks
    advance together over the key chunks.  ``causal_skip=True``: only
    the T(T+1)/2 causal chunk pairs are visited, as the reference's
    static pair list in row order, each row flushed to the output when
    the next pair starts another row; for sliding windows, pairs outside
    the band are dropped too."""
    b, t, h, hd = q.shape
    if t % chunk:
        raise ValueError(f"seq len {t} not divisible by chunk {chunk}")
    n = t // chunk
    kv = k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qc = _group_q(q, kv).reshape(b, n, chunk, kv, g, hd).movedim(1, 0)
    kc = k.reshape(b, n, chunk, kv, hd).movedim(1, 0)  # (n, B, chunk, KV, hd)
    vc = v.reshape(b, n, chunk, kv, hd).movedim(1, 0)

    if not causal_skip:
        qi = torch.arange(n, device=dev)
        carry = _init_carry((n,), b, chunk, kv, g, hd, dev)
        for ki in range(n):
            carry = _pair_update(carry, qi, ki, qc, kc[ki], vc[ki], chunk,
                                 scale, sliding_window)
        m, l, acc = carry
        out = acc / l[..., None]  # (n, B, chunk, KV, G, hd)
    else:
        pairs = [
            (i, j)
            for i in range(n)
            for j in range(n)
            if j <= i
            and (not sliding_window or (i - j) * chunk < sliding_window + chunk)
        ]
        out = torch.zeros((n, b, chunk, kv, g, hd), dtype=torch.float32, device=dev)
        carry = _init_carry((), b, chunk, kv, g, hd, dev)
        for idx, (i, j) in enumerate(pairs):
            carry = _pair_update(carry, torch.tensor(i, device=dev), j, qc[i],
                                 kc[j], vc[j], chunk, scale, sliding_window)
            # when the next pair starts a new q row, flush and reset
            if idx == len(pairs) - 1 or pairs[idx + 1][0] != i:
                m, l, acc = carry
                out[i] = acc / l[..., None]
                carry = _init_carry((), b, chunk, kv, g, hd, dev)

    out = out.movedim(0, 1).reshape(b, t, h, hd)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len, sliding_window: int = 0):
    """Single-token attention against a (possibly padded) KV cache,
    grouped-query form.  q: (B, 1, H, hd); caches (B, S, KV, hd);
    cache_len: a scalar or (B,) count of valid entries."""
    b, s, kv, hd = k_cache.shape
    h = q.shape[2]
    qg = _group_q(q, kv)  # (B, 1, KV, G, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float()
    scores = scores / math.sqrt(hd)
    ki = torch.arange(s, device=q.device)[None, None, None, None, :]
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1, 1, 1, 1)
    valid = ki < cl
    if sliding_window:
        valid &= ki >= cl - sliding_window
    scores = torch.where(valid, scores, _NEG)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache)
    return out.reshape(b, 1, h, hd)


def decode_attention_deferred(q, k_cache, v_cache, k_self, v_self, pos,
                              sliding_window: int = 0, k_scale=None,
                              v_scale=None):
    """Decode attention with the current token as a separate softmax term:
    the cache (B, Sc, KV, hd), WITHOUT the current token, is read-only in
    the layer loop and written once after it.  Ring semantics: slot
    pos % Sc holds a stale entry when pos >= Sc, masked out (it is the
    evicted position anyway).  ``pos`` is the current token's global
    position (a 0-d tensor or an int).

    int8 cache: the (B, Sc, KV) f32 scales factor out of the dot
    products (k_scale scales each key's scores, v_scale folds into the
    probabilities), so the cache is never dequantised into a full copy."""
    b, s, kv, hd = k_cache.shape
    h = q.shape[2]
    qg = _group_q(q, kv)  # (B, 1, KV, G, hd)
    scale = 1.0 / math.sqrt(hd)
    pos = torch.as_tensor(pos, device=q.device)

    kc = k_cache if k_scale is None else k_cache.to(q.dtype)
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, kc).float()
    if k_scale is None:
        sc = sc * scale
    else:
        sc = sc * (scale * k_scale.transpose(1, 2)[:, :, None, None, :])
    slot = pos % s
    ki = torch.arange(s, device=q.device)[None, None, None, None, :]
    valid = ki < torch.clamp(pos, max=s)
    valid &= (pos < s) | (ki != slot)  # the wrapped slot holds the evicted entry
    if sliding_window:
        valid &= ki >= pos + 1 - sliding_window
    sc = torch.where(valid, sc, _NEG)

    ss = torch.einsum("bqkgd,bqkd->bkgq", qg, k_self).float()[..., None] * scale

    m = torch.maximum(sc.amax(dim=-1, keepdim=True), ss)
    pc = torch.exp(sc - m)
    ps = torch.exp(ss - m)
    denom = pc.sum(dim=-1, keepdim=True) + ps
    pcn = pc / denom
    vc = v_cache
    if v_scale is not None:  # fold the dequant scales into the probabilities
        pcn = pcn * v_scale.transpose(1, 2)[:, :, None, None, :]
        vc = v_cache.to(q.dtype)
    out_c = torch.einsum("bkgqs,bskd->bqkgd", pcn.to(q.dtype), vc)
    w_self = (ps / denom)[..., 0].permute(0, 3, 1, 2)  # (B, 1, KV, G)
    out_s = w_self[..., None].to(q.dtype) * v_self[:, :, :, None, :]
    return (out_c + out_s).reshape(b, 1, h, hd)


def swiglu(x, w_gate, w_up, w_down):
    """LLaMA-style gated MLP: down(silu(x @ gate) * (x @ up))."""
    g = F.silu(torch.einsum("btd,df->btf", x, w_gate))
    u = torch.einsum("btd,df->btf", x, w_up)
    return torch.einsum("btf,fd->btd", g * u, w_down)
