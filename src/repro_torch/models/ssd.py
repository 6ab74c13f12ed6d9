"""Mamba-2 SSD (state-space duality) layer [arXiv:2405.21060], chunked: a
port of the reference's ``models/ssd.py``.

A sequential recurrence is blocked so that the work inside a block is
dense products and only a short scan over blocks stays sequential.

   y = SSD(x) :  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t h_t

Shapes: x (B, L, H, P); dt (B, L, H); A (H,) < 0; B, C (B, L, G, N);
heads H are grouped over G B/C groups (like GQA for attention).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_chunked", "ssd_decode_step", "ssd_reference", "causal_conv1d"]


def _expand_groups(bc, H):
    """(B, L, G, N) -> (B, L, H, N) by repeating each group H/G times."""
    B, L, G, N = bc.shape
    rep = H // G
    if rep == 1:
        return bc
    out = bc[:, :, :, None, :].expand(B, L, G, rep, N)
    return out.reshape(B, L, H, N)


def ssd_reference(x, dt, A, B, C, D=None):
    """Naive per-step recurrence (the oracle of the tests), O(L) steps."""
    Bm, L, H, P = x.shape
    N = B.shape[-1]
    Bh = _expand_groups(B, H).float()
    Ch = _expand_groups(C, H).float()
    xf = x.float()
    dtf = dt.float()
    h = torch.zeros((Bm, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        x_t, dt_t, B_t, C_t = xf[:, t], dtf[:, t], Bh[:, t], Ch[:, t]
        decay = torch.exp(dt_t * A)[..., None, None]  # (B, H, 1, 1)
        h = h * decay + (dt_t[..., None, None] * B_t[:, :, None, :]
                         * x_t[..., None])
        ys.append(torch.einsum("bhpn,bhn->bhp", h, C_t))
    y = torch.stack(ys, dim=1)  # (B, L, H, P)
    if D is not None:
        y = y + D[None, None, :, None].float() * xf
    return y.to(x.dtype)


def ssd_chunked(x, dt, A, B, C, D=None, chunk: int = 128, return_state=False):
    """Chunked SSD: dense products inside each chunk and a state scan
    over the chunks.

    With ``return_state`` also returns the final recurrent state
    (B, H, P, N), the decode-cache layout of ``ssd_decode_step``."""
    Bm, L, H, P = x.shape
    if L % chunk:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    nc = L // chunk
    Q = chunk
    N = B.shape[-1]
    Bh = _expand_groups(B, H).float()
    Ch = _expand_groups(C, H).float()
    xf = x.float()
    dtf = dt.float()

    # chunked views: (B, nc, Q, ...)
    xc = xf.reshape(Bm, nc, Q, H, P)
    dtc = dtf.reshape(Bm, nc, Q, H)
    Bc = Bh.reshape(Bm, nc, Q, H, N)
    Cc = Ch.reshape(Bm, nc, Q, H, N)

    dA = dtc * A  # (B, nc, Q, H), <= 0
    A_cs = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    A_tot = A_cs[:, :, -1]  # (B, nc, H)

    # ---- intra-chunk (dense) ----
    # Lmat[q, k] = exp(A_cs[q] - A_cs[k]) for k <= q (segment decay).
    # double where: the masked upper triangle has diff > 0, whose exp can
    # overflow, so it is zeroed BEFORE the exp
    diff = A_cs[:, :, :, None, :] - A_cs[:, :, None, :, :]  # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    tri = tri[None, None, :, :, None]
    diff = torch.where(tri, diff, 0.0)
    Lmat = torch.where(tri, torch.exp(diff), 0.0)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc) * Lmat
    xdt = xc * dtc[..., None]  # dt-weighted inputs
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores, xdt)

    # ---- chunk summary states ----
    # S_c = sum_k exp(A_tot - A_cs[k]) B_k (x_k dt_k)^T   (B,nc,H,N,P)
    decay_out = torch.exp(A_tot[:, :, None, :] - A_cs)  # (B,nc,Q,H)
    S_c = torch.einsum("bcqhn,bcqh,bcqhp->bchnp", Bc, decay_out, xdt)

    # ---- inter-chunk recurrence (short scan over nc) ----
    h = torch.zeros((Bm, H, N, P), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)  # the state BEFORE this chunk
        h = h * torch.exp(A_tot[:, c])[:, :, None, None] + S_c[:, c]
    h_last = h
    h_prev = torch.stack(h_prev, dim=1)  # (B, nc, H, N, P)

    # ---- inter-chunk contribution ----
    y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Cc, h_prev, torch.exp(A_cs))

    y = (y_intra + y_off).reshape(Bm, L, H, P)
    if D is not None:
        y = y + D[None, None, :, None].float() * xf
    y = y.to(x.dtype)
    if return_state:
        # ssd_decode_step keeps the state as (B, H, P, N)
        return y, h_last.transpose(2, 3)
    return y


def ssd_decode_step(h, x_t, dt_t, A, B_t, C_t, D=None):
    """One-token SSD update.  h: (B, H, P, N) f32 state.

    Returns (h_next, y_t (B, H, P))."""
    H = x_t.shape[1]
    B_t = _expand_groups(B_t[:, None], H)[:, 0].float()
    C_t = _expand_groups(C_t[:, None], H)[:, 0].float()
    xf = x_t.float()
    dtf = dt_t.float()
    decay = torch.exp(dtf * A)[..., None, None]
    h = h * decay + dtf[..., None, None] * xf[..., None] * B_t[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, C_t)
    if D is not None:
        y = y + D[None, :, None] * xf
    return h, y.to(x_t.dtype)


def causal_conv1d(u, w, bias=None):
    """Depthwise causal conv.  u: (B, L, Ch), w: (W, Ch).  Returns (B, L, Ch)."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(W):  # W is small (4): unrolled taps
        out = out + pad[:, i : i + u.shape[1]].float() * w[i]
    if bias is not None:
        out = out + bias
    return out.to(u.dtype)
