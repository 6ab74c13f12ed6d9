"""Matrix-form Viterbi decoding (paper §V, §VIII) in PyTorch.

The forward ACS recursion is ONE fused matmul per radix-2^rho step:

    potentials = [L_t | Lambda_{t-rho}] @ [Theta-hat^T ; P]
    Lambda_t   = max_slots    potentials
    phi_t      = argmax_slots potentials   (ties go to the first slot)

``forward_fused(use_kernel=True)`` (the default) runs that recursion in
K1, the hand-written CUDA kernel of ``repro_torch.kernels`` (or its plain
version for CPU tensors) with the kernel's contract: blocks rounded
straight to the matmul dtype, ``split_dot`` ignored.
``use_kernel=False`` runs the plain scan below with the reference's scan
contract: blocks through ``channel_dtype`` first, ``split_dot`` honoured.
The traceback is plain PyTorch, as it is plain jnp in the reference.

``tiled_decode_stream`` decodes one long stream as overlapping windows
(paper §III): through K2 (one pass, the traceback in the kernel) when
the reference's one-pass rule admits the window, through the
time-parallel decode (``core/timeparallel.py``) when its plan picks it,
else two-pass.  ``tiled_decode_streams`` does the same for N streams in
one window decode, their windows folded into the frame axis.

Precision follows the paper's Fig. 13 axes (``AcsPrecision``): matmul
inputs may be bf16, products and sums are f32, and the carry may be
rounded to bf16.  No path uses TF32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.obs.trace import host_upload, stage

from .backend import device_underfill_rows, resolve_device
from .kernel_geometry import (
    SLOT_BITS,
    check_packable,
    one_pass_time_tile,
    pack_slots,
    ring_auto_packed,
    ring_dtype,
    ring_words,
    time_parallel_plan,
)
from .semiring import NEG, TROPICAL, Semiring
from .trellis import AcsTables, CodeSpec, build_acs_tables

__all__ = [
    "AcsPrecision",
    "dot_f32",
    "fused_potentials",
    "blocks_from_llrs",
    "init_metric",
    "forward_fused",
    "traceback",
    "traceback_with_state",
    "decode_frames",
    "TiledDecoderConfig",
    "tiled_decode_stream",
    "tiled_decode_streams",
    "NEG",
]

_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


@dataclasses.dataclass(frozen=True)
class AcsPrecision:
    """Precision knobs mirroring the paper's Table I / Fig. 13 axes."""

    matmul_dtype: torch.dtype = torch.float32  # A/B operands (paper: half)
    carry_dtype: torch.dtype = torch.float32  # accumulated path metric
    channel_dtype: torch.dtype = torch.float32  # LLR storage
    renorm: bool = True  # subtract per-frame max every step
    split_dot: bool = False  # branch metrics in matmul_dtype, routing in f32

    def label(self) -> str:
        """The reference's row name: every knob that changes the
        arithmetic is encoded."""
        parts = [
            f"C={_SHORT.get(self.carry_dtype, self.carry_dtype)}",
            f"mm={_SHORT.get(self.matmul_dtype, self.matmul_dtype)}",
            f"ch={_SHORT.get(self.channel_dtype, self.channel_dtype)}",
        ]
        if self.split_dot:
            parts.append("split")
        if not self.renorm:
            parts.append("norenorm")
        return ",".join(parts)

    def carry_mantissa_digits(self) -> int:
        """Significand width of the carry dtype, implicit bit included
        (f32: 24, f16: 11, bf16: 8)."""
        return round(-math.log2(torch.finfo(self.carry_dtype).eps)) + 1

    def carry_absorb_limit(self) -> float:
        """Carry magnitude beyond which adding a unit-scale increment
        loses at least one bit of it (2**mantissa_digits)."""
        return float(2.0 ** self.carry_mantissa_digits())

    def carry_max(self) -> float:
        """Largest finite value of the carry dtype."""
        return float(torch.finfo(self.carry_dtype).max)


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with products and sums in IEEE f32, whatever dtype the
    operands were rounded to (the reference's
    ``preferred_element_type=f32``).  Refuses to run under TF32."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the ACS "
            "potentials need IEEE f32 products; turn TF32 off"
        )
    return a.to(torch.float32) @ b.to(torch.float32)


def fused_potentials(
    l_t: torch.Tensor,  # (rows, B) LLR block
    lam: torch.Tensor,  # (rows, S) path metrics
    w: torch.Tensor,  # (B+S, S*R) stacked [Theta^T ; P] in matmul dtype
    w_theta: torch.Tensor,  # (B, S*R) in matmul dtype
    w_pred: torch.Tensor,  # (S, S*R) f32 one-hot
    precision: AcsPrecision,
) -> torch.Tensor:
    """One fused-ACS matmul: branch metrics + path-metric routing, f32
    products and sums.  Returns (rows, S*R) f32 potentials."""
    mm = precision.matmul_dtype
    if precision.split_dot:
        return dot_f32(l_t.to(mm), w_theta) + dot_f32(
            lam.to(torch.float32), w_pred
        )
    x = torch.cat([l_t.to(mm), lam.to(mm)], dim=1)
    return dot_f32(x, w)


def blocks_from_llrs(llrs: torch.Tensor, rho: int) -> torch.Tensor:
    """(F, n, beta) LLRs -> (T', F, rho*beta) fused-step blocks (a view).

    n must be divisible by rho (pad with zero LLRs beforehand — a zero LLR
    carries no information and does not bias the path metrics).
    """
    F, n, beta = llrs.shape
    if n % rho:
        raise ValueError(f"n={n} not divisible by rho={rho}")
    # stage-major flattening matches trellis.superbranch_output_bits order
    return llrs.reshape(F, n // rho, rho * beta).permute(1, 0, 2)


def init_metric(
    n_frames: int,
    n_states: int,
    initial_state: Optional[int],
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Metric at t=0: one-hot (known encoder start) or uniform (truncated),
    on ``device`` (None is the card)."""
    device = resolve_device(device)
    if initial_state is None:
        return torch.zeros((n_frames, n_states), dtype=torch.float32, device=device)
    lam = torch.full(
        (n_frames, n_states), NEG, dtype=torch.float32, device=device
    )
    lam[:, initial_state] = 0.0
    return lam


def forward_fused(
    blocks: torch.Tensor,
    lam0: torch.Tensor,
    tables: AcsTables,
    precision: AcsPrecision = AcsPrecision(),
    use_kernel: bool = True,
    pack_survivors: bool = False,
    semiring: Semiring = TROPICAL,
):
    """Fused forward procedure on the tensors' device.

    blocks: (T', F, rho*beta); lam0: (F, S).
    Returns (lam_final (F, S) f32, phis) with phis (T', F, S) int8 slots,
    or (T', F, S//16) int32 when ``pack_survivors`` (rho <= 2 only).
    """
    if use_kernel:
        from repro_torch.kernels import ops as kernel_ops

        return kernel_ops.viterbi_forward(
            blocks, lam0, tables, precision, pack_survivors=pack_survivors,
            semiring=semiring.name,
        )

    S, R = tables.n_states, tables.n_slots
    if pack_survivors:
        check_packable(S, R)
    dev = blocks.device
    mm = precision.matmul_dtype
    T, F = blocks.shape[0], blocks.shape[1]
    with stage("forward", device=dev, steps=T):
        W = host_upload(tables.fused_w, dev).to(mm)
        W_theta = host_upload(tables.theta_t, dev).to(mm)
        W_pred = host_upload(tables.pred_onehot, dev)
        blocks = blocks.to(precision.channel_dtype)
        phis = torch.empty(
            (T, F, ring_words(S, pack_survivors)),
            dtype=ring_dtype(pack_survivors), device=dev,
        )
        lam = lam0.to(precision.carry_dtype)
        for t in range(T):
            pot = fused_potentials(blocks[t], lam, W, W_theta, W_pred, precision)
            pot = pot.view(F, S, R)
            new_lam = semiring.sum(pot, dim=-1)
            phi = pot.argmax(dim=-1)
            phis[t] = pack_slots(phi, R) if pack_survivors else phi
            if precision.renorm:
                new_lam = new_lam - new_lam.amax(dim=-1, keepdim=True)
            lam = new_lam.to(precision.carry_dtype)
    return lam.to(torch.float32), phis


def _traceback_scan(
    phis: torch.Tensor, final_state: torch.Tensor, tables: AcsTables
):
    """Algorithm 2 over frames, one radix step at a time, newest first.

    Returns (start_state (F,), bits (F, T'*rho) int32), where start_state
    is the survivor path's state BEFORE the first step in ``phis``."""
    k, rho, R = tables.spec.k, tables.rho, tables.n_slots
    shift = k - 1 - rho
    mask = (1 << shift) - 1
    packed = phis.dtype == torch.int32
    slot_bits = SLOT_BITS[R]
    T, F = phis.shape[0], phis.shape[1]
    with stage("traceback", device=phis.device, steps=T):
        j = final_state.to(device=phis.device, dtype=torch.int64)
        states = torch.empty((T, F), dtype=torch.int64, device=phis.device)
        for t in range(T - 1, -1, -1):
            states[t] = j
            if packed:
                word = phis[t].gather(1, (j >> 4)[:, None])[:, 0].to(torch.int64)
                slot = (word >> (slot_bits * (j & 15))) & (R - 1)
            else:
                slot = phis[t].gather(1, j[:, None])[:, 0].to(torch.int64)
            j = ((j & mask) << rho) | slot
        # the rho decoded bits of each step are the top rho bits of its
        # state, chronological = LSB-first of that field
        v = states >> shift  # (T', F)
        bits = (v[..., None] >> torch.arange(rho, device=phis.device)) & 1
        bits = bits.permute(1, 0, 2).reshape(F, T * rho)
        return j.to(torch.int32), bits.to(torch.int32)


def traceback(
    phis: torch.Tensor, final_state: torch.Tensor, tables: AcsTables
) -> torch.Tensor:
    """Vectorized Algorithm 2 over frames.

    phis: (T', F, S) int8 slots OR (T', F, S//16) int32 packed (unpacked
    lazily per step); final_state: (F,).  Returns decoded bits
    (F, T'*rho) int32.
    """
    return _traceback_scan(phis, final_state, tables)[1]


def traceback_with_state(
    phis: torch.Tensor, final_state: torch.Tensor, tables: AcsTables
):
    """``traceback`` that also returns the path's start state (F,)."""
    return _traceback_scan(phis, final_state, tables)


def decode_frames(
    llrs,
    spec: CodeSpec,
    rho: int = 2,
    initial_state: Optional[int] = 0,
    final_state: Optional[int] = None,
    precision: AcsPrecision = AcsPrecision(),
    use_kernel: bool = True,
    pack_survivors: bool = False,
    device=None,
) -> torch.Tensor:
    """Decode a batch of independent frames.  llrs: (F, n, beta), n a
    multiple of rho.  ``device=None`` is the card (see
    ``backend.resolve_device``).  Returns (F, n) int32 bits."""
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    tables = build_acs_tables(spec, rho)
    blocks = blocks_from_llrs(llrs, rho)
    F = llrs.shape[0]
    lam0 = init_metric(F, spec.n_states, initial_state, device=dev)
    lam, phis = forward_fused(
        blocks, lam0, tables, precision, use_kernel, pack_survivors
    )
    if final_state is None:
        fs = lam.argmax(dim=-1)
    else:
        fs = torch.full((F,), final_state, dtype=torch.int64, device=dev)
    return traceback(phis, fs, tables)


# ---------------------------------------------------------------------------
# Tiled stream decoder (paper §III tiling over a frames-in-rows batch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TiledDecoderConfig:
    """Frame tiling (paper §III): each window decodes ``frame_len`` bits
    and carries ``overlap`` stages of history on both sides (Eq. 5's v)."""

    frame_len: int = 64
    overlap: int = 32
    rho: int = 2

    def __post_init__(self):
        if (self.frame_len + 2 * self.overlap) % self.rho:
            raise ValueError("frame_len + 2*overlap must be divisible by rho")
        if self.frame_len % self.rho:
            raise ValueError("frame_len must be divisible by rho")

    @property
    def window(self) -> int:
        return self.frame_len + 2 * self.overlap


def _one_pass_window_plan(
    spec: CodeSpec,
    cfg: TiledDecoderConfig,
    pack_survivors: bool,
    time_tile: Optional[int],
    block_frames: Optional[int],
):
    """(time_tile, ring_packed) for decoding the windows through K2, or
    None for the two-pass path: the shared ``one_pass_time_tile`` rule,
    plus an overlap on the rho grid (the ring holds whole radix steps)."""
    v, rho = cfg.overlap, cfg.rho
    if v % rho:
        return None
    packed = ring_auto_packed(spec.n_states, pack_survivors, 1 << rho)
    tt = one_pass_time_tile(
        v // rho, cfg.window // rho, spec.n_states, packed,
        time_tile, block_frames,
    )
    return None if tt is None else (tt, packed)


def _one_pass_windows(
    frames: torch.Tensor,  # (n_windows, window, beta)
    spec: CodeSpec,
    cfg: TiledDecoderConfig,
    precision: AcsPrecision,
    time_tile: int,
    ring_packed: bool,
) -> torch.Tensor:
    """Decode tiling windows through K2.

    The left overlap is the warm-up and the right one the lookahead: with
    a decision depth of overlap/rho steps, every centre stage is committed
    with >= overlap stages of lookahead, and K2's rows [2*overlap:) are
    exactly the centres, so no flush traceback is needed.
    """
    from repro_torch.kernels import ops as kernel_ops

    v, rho = cfg.overlap, cfg.rho
    dev = frames.device
    blocks = blocks_from_llrs(frames, rho)
    n_windows = frames.shape[0]
    lam0 = init_metric(n_windows, spec.n_states, None, device=dev)
    hist0 = torch.zeros(
        (v // rho, n_windows, ring_words(spec.n_states, ring_packed)),
        dtype=ring_dtype(ring_packed), device=dev,
    )
    bits, _, _ = kernel_ops.viterbi_decode_fused(
        blocks, lam0, hist0, build_acs_tables(spec, rho), precision,
        time_tile=time_tile, pack_survivors=ring_packed,
    )
    # row r <-> stage r - v; the centres are stages [v, v+f) = rows [2v, 2v+f)
    return bits[2 * v:, :].T.to(torch.int32)  # (n_windows, f)


def tiled_decode_stream(
    llrs,
    spec: CodeSpec,
    cfg: TiledDecoderConfig = TiledDecoderConfig(),
    precision: AcsPrecision = AcsPrecision(),
    use_kernel: bool = True,
    pack_survivors: bool = False,
    one_pass: bool = False,
    time_tile: Optional[int] = None,
    block_frames: Optional[int] = None,
    time_parallel: Optional[bool] = None,
    transfer_tile: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Decode one long LLR stream (n, beta) as overlapping windows.

    The stream is zero-LLR padded by ``overlap`` on both ends and cut
    into ceil(n/frame_len) windows of frame_len + 2*overlap stages, all
    decoded at once (uniform start metric, argmax end state); the centre
    frame_len decisions of each window are stitched together.  Returns
    (n,) int32 bits on ``device`` (None is the card).

    With ``one_pass`` the windows go through K2 when the reference's
    one-pass rule admits them (``_one_pass_window_plan``).  Otherwise they
    go through ``decode_time_parallel`` (K3, then K1) when
    ``time_parallel_plan`` picks it for this device, and else through
    ``decode_frames``.  An explicit ``time_parallel=True`` beats an
    eligible one-pass plan; on auto the one-pass plan wins, as in the
    reference.  This is ``tiled_decode_streams`` on a batch of one.
    """
    llrs = torch.as_tensor(llrs)
    return tiled_decode_streams(
        llrs[None], spec, cfg, precision, use_kernel, pack_survivors,
        one_pass, time_tile, block_frames, time_parallel, transfer_tile,
        device,
    )[0]


def tiled_decode_streams(
    llrs,
    spec: CodeSpec,
    cfg: TiledDecoderConfig = TiledDecoderConfig(),
    precision: AcsPrecision = AcsPrecision(),
    use_kernel: bool = True,
    pack_survivors: bool = False,
    one_pass: bool = False,
    time_tile: Optional[int] = None,
    block_frames: Optional[int] = None,
    time_parallel: Optional[bool] = None,
    transfer_tile: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """``tiled_decode_stream`` of N streams (N, n, beta) at once: every
    stream's windows are folded into the frame axis of ONE window decode
    (one K2 launch, or one ``decode_frames`` or ``decode_time_parallel``
    call), never a loop over the streams.  Returns (N, n) int32 bits.

    The reference maps ``tiled_decode_stream`` over the streams
    (``jax.vmap``), so each stream picks its path from its own window
    count; here too: the one-pass rule takes no frame count, and the
    time-parallel plan is asked with one stream's windows.  Each stream's
    edge pads are its own (its first window starts ``overlap`` zero
    stages before it, its last ends ``overlap`` after), so each row of
    the result is what ``tiled_decode_stream`` returns for that stream.
    """
    dev = resolve_device(device)
    llrs = torch.as_tensor(llrs, device=dev).to(torch.float32)
    N, n, beta = llrs.shape
    f, v = cfg.frame_len, cfg.overlap
    n_windows = -(-n // f)
    padded_len = n_windows * f + 2 * v
    with stage("window_gather", device=dev):
        padded = torch.nn.functional.pad(llrs, (0, 0, v, padded_len - n - v))
        idx = (
            torch.arange(n_windows, device=dev)[:, None] * f
            + torch.arange(cfg.window, device=dev)[None, :]
        )
        # (N * n_windows, window, beta), stream-major
        frames = padded[:, idx].reshape(N * n_windows, cfg.window, beta)
    tp_tile = time_parallel_plan(
        n_windows, cfg.window // cfg.rho, spec.n_states,
        time_parallel, transfer_tile, device_underfill_rows(dev),
    )
    plan = (
        _one_pass_window_plan(spec, cfg, pack_survivors, time_tile, block_frames)
        if one_pass else None
    )
    # an explicitly requested time-parallel path beats the one-pass plan;
    # on auto, an eligible one-pass plan wins
    if plan is not None and not (time_parallel is True and tp_tile):
        center = _one_pass_windows(frames, spec, cfg, precision, *plan)
        return center.reshape(N, n_windows * f)[:, :n]
    if tp_tile is not None:
        from .timeparallel import decode_time_parallel

        decoded = decode_time_parallel(
            frames, spec, rho=cfg.rho, initial_state=None, final_state=None,
            precision=precision, transfer_tile=tp_tile,
            use_kernel=use_kernel, pack_survivors=pack_survivors, device=dev,
        )
    else:
        decoded = decode_frames(
            frames, spec, rho=cfg.rho, initial_state=None, final_state=None,
            precision=precision, use_kernel=use_kernel,
            pack_survivors=pack_survivors, device=dev,
        )
    return decoded[:, v:v + f].reshape(N, n_windows * f)[:, :n]
