"""Mixture-of-Experts FFN (Mixtral 8e top-2; Arctic 128e top-2 + dense
residual) with static-shape capacity dispatch: a port of the reference's
``models/moe.py``.

Dispatch is per *group* (a group = one batch row for train/prefill, the
whole batch for decode): tokens are routed top-k, given a position in
their expert's capacity buffer by a cumulative count, scattered to a
(G, E, C, D) buffer, run through a batched expert einsum, and gathered
back weighted by the router probabilities.  Pairs beyond capacity are
dropped (GShard semantics) into a sink row at E*C; capacity_factor sets
the slack.

The experts' sharding (EP over "model" when E divides it, else TP over
the expert FFN dim) is chosen in ``models/lm.py::_ffn_block`` from the
ambient mesh and pins nothing here (``distributed/sharding.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["MoEMetrics", "router_topk", "moe_ffn"]


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor  # load-balance loss (Switch Eq. 4)
    z_loss: torch.Tensor  # router logit magnitude regularizer
    drop_frac: torch.Tensor  # fraction of token-expert pairs dropped


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index.  ``torch.topk`` promises no order among ties; a stable
    descending sort does."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def router_topk(x, w_router, top_k: int):
    """x: (G, T, D) -> (logits, probs (G,T,E) f32, top_p (G,T,K) f32
    renormalised, top_ids (G,T,K) int32)."""
    logits = torch.einsum("gtd,de->gte", x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = _top_k(probs, top_k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)  # renormalize
    return logits, probs, top_p, top_ids.to(torch.int32)


def moe_ffn(x: torch.Tensor, params: dict, top_k: int,
            capacity_factor: float = 1.25):
    """x: (G, T, D), G groups dispatching independently; params: router
    (D,E), w_gate/w_up (E,D,F), w_down (E,F,D).  Returns (out (G,T,D),
    MoEMetrics)."""
    G, T, D = x.shape
    E = params["router"].shape[-1]
    K = top_k
    C = max(int(math.ceil(T * K / E * capacity_factor)), 1)

    logits, probs, top_p, top_ids = router_topk(x, params["router"], K)

    # position of each (token, k) pair within its expert, per group
    flat_ids = top_ids.reshape(G, T * K).long()  # slot-major: token t, slot k
    onehot = F.one_hot(flat_ids, E)  # (G, TK, E)
    pos = torch.cumsum(onehot, dim=1) - 1  # (G, TK, E)
    pos_in_expert = torch.gather(pos, -1, flat_ids[..., None])[..., 0]  # (G, TK)
    keep = pos_in_expert < C
    drop_frac = 1.0 - keep.float().mean()

    # scatter tokens into the capacity buffer (G, E*C, D); row E*C is the
    # sink of the dropped pairs
    dest = torch.where(keep, flat_ids * C + pos_in_expert, E * C)
    tokens = torch.repeat_interleave(x, K, dim=1)  # (G, T*K, D)
    buf = torch.zeros((G, E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[torch.arange(G, device=x.device)[:, None], dest] = tokens
    buf = buf[:, : E * C].reshape(G, E, C, D)

    # batched expert SwiGLU
    g = F.silu(torch.einsum("gecd,edf->gecf", buf, params["w_gate"]))
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    y = torch.einsum("gecf,efd->gecd", g * u, params["w_down"])
    y = y.reshape(G, E * C, D)

    # gather back, weighted by the renormalised router probs
    y = torch.cat([y, torch.zeros((G, 1, D), dtype=y.dtype, device=y.device)], dim=1)
    back = torch.gather(y, 1, dest[..., None].expand(G, T * K, D))  # (G, TK, D)
    w = (top_p.reshape(G, T * K) * keep).to(x.dtype)
    out = (back * w[..., None]).reshape(G, T, K, D).sum(dim=2)

    # Switch load-balance loss: E * sum_e f_e * P_e
    f_e = F.one_hot(top_ids.long(), E).float().mean(dim=(1, 2)).mean(0)
    p_e = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return out, MoEMetrics(aux, z, drop_frac)
