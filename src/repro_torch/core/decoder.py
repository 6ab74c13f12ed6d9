"""Decoder front door: ``ViterbiDecoder``.

Every registry code decodes through it (``ViterbiDecoder.from_standard``):
zero-terminated and tail-biting frames, with or without puncturing.

  * ``decode_batch`` — one-shot decode of independent frames (the
    paper's §IX workload): on the sequential path, the forward pass in
    K1 and a plain PyTorch traceback; or on the time-parallel path
    (``core/timeparallel.py``: transfer matrices in K3, a log-depth scan,
    every tile re-run at once in K1 and one traceback over all tiles),
    on request or when the frames alone leave the card idle
    (``backend.device_underfill_rows``).  Tail-biting frames go to
    ``decode_tailbiting``;
  * ``decode_tailbiting`` — the wrap-around Viterbi algorithm
    (``codes/tailbiting.py``): K1 once per circulation, or with the
    time-parallel plan K3 once and K1 per circulation;
  * ``decode_stream_tiled`` — overlapping-window decode of one stream
    (paper §III), through K2 when the one-pass rule admits the window;
  * ``init_stream_state`` / ``decode_chunk`` / ``decode_chunk_multi`` /
    ``flush_stream`` / ``decode_stream_chunked`` — stateful chunked
    streaming: the path metrics and a decision-depth survivor ring are
    carried across chunks, and decisions are emitted once they have
    ``decision_depth`` stages of lookahead.  A chunk takes K2 (one pass,
    the traceback in the kernel) when the reference's one-pass rule
    admits it, else the two-pass step (K1, then a plain traceback over
    the ring and the chunk);
  * ``decode_soft`` — BCJR per-bit LLRs or their hard decisions
    (``core/soft.py``: LOGPROB transfer matrices in K3-LOGPROB, log-depth
    scans, the within-tile alpha and beta sweeps and the LLR combine in
    K6 on the card, plain scans off it; the exact circular BCJR for
    tail-biting frames), and top-L list-Viterbi (plain scans; the WAVA
    list loop for tail-biting frames);
  * ``decode_sharded`` — ``decode_batch``'s sequential path with the
    frames split over the shards of a ``distributed.decoder.FrameMesh``,
    K1 once a shard.

A punctured decoder takes the serial kept-LLR stream, (F, Lp) for the
batch, chunked and soft entry points and (Lp,) for the tiled one, and
re-inserts zero-LLR erasures (``depunctured``); the depunctured stages
flow through the same kernels.  Its decision depth and tiled overlap are
stretched by the puncture expansion.

``from_config`` builds a decoder from a ``configs/viterbi_k7.py``
service config.

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises where there is none; the CPU is used only when asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as tnf

from repro_torch.obs.trace import host_read, stage

from .backend import device_underfill_rows, resolve_device
from .kernel_geometry import (
    one_pass_time_tile,
    ring_auto_packed,
    ring_dtype,
    ring_words,
    time_parallel_plan,
)
from .trellis import AcsTables, CodeSpec, build_acs_tables
from .validate import (
    InvalidInputError,
    RenormGuard,
    batch_headroom_check,
    validate_llrs,
)
from .viterbi import (
    AcsPrecision,
    TiledDecoderConfig,
    blocks_from_llrs,
    decode_frames,
    forward_fused,
    init_metric,
    tiled_decode_stream,
    traceback,
)

__all__ = [
    "StreamState",
    "ViterbiDecoder",
    "DEFAULT_DECISION_DEPTH",
    "InvalidInputError",
]

# ~5K stages of decision delay: survivor merge is certain for any
# constraint length served, at ~decision_depth * S / 8 bytes of state
DEFAULT_DECISION_DEPTH = 5120


def _count_dispatch(path: str) -> None:
    """Path-selection counter in the library-wide default registry (a
    no-op ``NullRegistry`` until observability installs a real one)."""
    from repro_torch.obs.metrics import default_registry

    default_registry().counter(
        "decoder_dispatch_total",
        "ViterbiDecoder dispatches by selected decode path",
    ).inc(1, path=path)


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Carry of the chunked streaming decoder.

    lam  : (F, S) f32 path metrics at the current stream front.
    hist : (D, F, S) int8 survivor ring (or (D, F, S//16) int32 packed),
           in time order: hist[i] is radix step ``pos - D + i``; entries
           for negative steps are zero filler, never emitted.
    pos  : radix steps consumed so far.
    """

    lam: torch.Tensor
    hist: torch.Tensor
    pos: int

    @property
    def depth_steps(self) -> int:
        return self.hist.shape[0]

    @property
    def n_frames(self) -> int:
        return self.lam.shape[0]


def _chunk_step(
    hist: torch.Tensor,
    lam: torch.Tensor,
    blocks: torch.Tensor,
    tables: AcsTables,
    precision: AcsPrecision,
    use_kernel: bool,
    pack_survivors: bool,
):
    """One two-pass streaming chunk: T new ACS steps (K1) and one delayed
    traceback over the ring and the chunk.

    Returns (new_hist, new_lam, bits (F, T*rho)): the decisions for the
    T oldest steps of the window [pos-D, pos+T), i.e. steps
    [pos-D, pos+T-D), each with >= D steps of lookahead.
    """
    lam2, phis = forward_fused(
        blocks, lam, tables, precision, use_kernel, pack_survivors
    )
    full = torch.cat([hist, phis], dim=0)  # (D+T, F, W)
    bits = traceback(full, lam2.argmax(dim=-1), tables)
    T = phis.shape[0]
    return full[full.shape[0] - hist.shape[0]:], lam2, bits[:, :T * tables.rho]


def _chunk_step_fused(
    hist: torch.Tensor,
    lam: torch.Tensor,
    blocks: torch.Tensor,
    tables: AcsTables,
    precision: AcsPrecision,
    time_tile: int,
    pack_survivors: bool,
):
    """``_chunk_step`` in K2: the survivor window stays in the kernel's
    ring and the delayed traceback runs in the kernel, one commit per
    time tile.  Same contract and bits as ``_chunk_step`` at chunk =
    time_tile."""
    from repro_torch.kernels import ops as kernel_ops

    bits, lam2, hist2 = kernel_ops.viterbi_decode_fused(
        blocks, lam, hist, tables, precision,
        time_tile=time_tile, pack_survivors=pack_survivors,
    )
    return hist2, lam2, bits.T.to(torch.int32)


def _window_valid(pos: int, t_steps: int, depth_steps: int) -> int:
    """How many of the window's T oldest steps are real stream steps at
    stream position ``pos``: the window covers steps [pos-D, pos+T-D),
    and steps before the stream start are warm-up filler."""
    return max(0, pos + t_steps - depth_steps) - max(0, pos - depth_steps)


def _flush_step(
    hist: torch.Tensor,
    lam: torch.Tensor,
    tables: AcsTables,
    final_state: Optional[int],
):
    """Commit the last D steps still in the ring (end of stream)."""
    if final_state is None:
        fs = lam.argmax(dim=-1)
    else:
        fs = torch.full(
            (lam.shape[0],), final_state, dtype=torch.int64, device=lam.device
        )
    return traceback(hist, fs, tables)  # (F, D*rho)


class ViterbiDecoder:
    """One front door per (code, radix, precision, device).

    The fused-ACS tables are built once at construction.  ``use_kernel``
    (default True) runs the forward pass in K1 (and the time-parallel and
    soft paths' formation in K3, their scans' compose in K4) — the CUDA
    kernel on the card, its plain version on the CPU; ``use_kernel=False``
    runs the plain versions directly, the scan with ``split_dot``
    honoured.  ``one_pass`` (default:
    ``use_kernel``) sends streaming chunks and tiled windows through K2
    where the one-pass rule admits them; ``time_tile`` and
    ``block_frames`` are that rule's inputs, as in the reference.
    ``time_parallel`` (None: auto) and ``transfer_tile`` are the inputs
    of the time-parallel plan (``kernel_geometry.time_parallel_plan``),
    which reckons with this device's budget.

    Auto-selection is per device: on the card the budget is
    ``backend.CUDA_ROW_BUDGET`` (16,384 rows, measured on an H100), where
    the reference uses 1,024 on any accelerator, so for 1,024 < F x S <=
    16,384 the port's ``decode_batch`` on auto takes the time-parallel
    path where the reference takes the sequential one.  On exactly tied
    inputs the two paths can return different bits, and the
    time-parallel one need not be an ML path.  Parity with the
    reference is held per path: pass ``time_parallel=True`` or
    ``False`` to compare like with like.
    """

    def __init__(
        self,
        spec: CodeSpec,
        rho: int = 2,
        precision: Optional[AcsPrecision] = None,
        use_kernel: bool = True,
        pack_survivors: bool = False,
        decision_depth: int = DEFAULT_DECISION_DEPTH,
        puncture=None,  # codes.PuncturePattern | None
        termination: str = "zero",
        one_pass: Optional[bool] = None,
        time_tile: Optional[int] = None,
        block_frames: Optional[int] = None,
        time_parallel: Optional[bool] = None,
        transfer_tile: Optional[int] = None,
        validate_inputs: bool = True,
        sanitize: bool = False,
        device=None,
    ):
        if decision_depth % rho:
            raise ValueError(
                f"decision_depth={decision_depth} not divisible by rho={rho}"
            )
        if termination not in ("zero", "tailbiting"):
            raise ValueError(f"unknown termination {termination!r}")
        if puncture is not None and puncture.beta != spec.beta:
            raise ValueError(
                f"puncture beta={puncture.beta} != code beta={spec.beta}"
            )
        self.device = resolve_device(device)
        self.spec = spec
        self.rho = rho
        self.tables = build_acs_tables(spec, rho)
        self.precision = precision or AcsPrecision()
        self.use_kernel = use_kernel
        self.pack_survivors = pack_survivors
        self.puncture = puncture
        self.termination = termination
        # one-pass streaming: on with the kernels, so streaming chunks and
        # tiled windows keep their survivors in K2's ring
        self.one_pass = use_kernel if one_pass is None else bool(one_pass)
        self.time_tile = time_tile
        self.block_frames = block_frames
        self.time_parallel = time_parallel
        self.transfer_tile = transfer_tile
        # the streaming ring is packed whenever the state count allows and
        # one-pass is on; batch survivors pack only on request
        self.ring_packed = (
            ring_auto_packed(spec.n_states, pack_survivors, 1 << rho)
            if self.one_pass else pack_survivors
        )
        if puncture is not None:
            # punctured stages carry fewer real LLRs, so survivor merge
            # takes ~expansion x more stages: stretch the decision delay,
            # on the rho grid
            decision_depth = int(
                -(-int(decision_depth * puncture.expansion) // rho) * rho
            )
        self.decision_depth = decision_depth
        # input hardening: validate every entry point (strict raise, or
        # clamp-and-count with sanitize=True); no-renorm precisions get
        # the renorm-cadence guard, which observes the carry between
        # streaming chunks and renormalises it before headroom runs out
        self.validate_inputs = validate_inputs
        self.sanitize = sanitize
        self.sanitized_total = 0
        self.renorm_guard: Optional[RenormGuard] = (
            RenormGuard.for_precision(self.precision)
            if (validate_inputs and not self.precision.renorm) else None
        )

    @classmethod
    def from_standard(
        cls,
        name: str,
        rho: int = 2,
        precision: Optional[AcsPrecision] = None,
        use_kernel: bool = True,
        pack_survivors: bool = False,
        decision_depth: int = DEFAULT_DECISION_DEPTH,
        one_pass: Optional[bool] = None,
        time_tile: Optional[int] = None,
        block_frames: Optional[int] = None,
        time_parallel: Optional[bool] = None,
        transfer_tile: Optional[int] = None,
        validate_inputs: bool = True,
        sanitize: bool = False,
        device=None,
    ) -> "ViterbiDecoder":
        """Resolve a ``repro_torch.codes.registry`` entry — mother code,
        puncture pattern and termination — into a decoder, e.g.
        ``ViterbiDecoder.from_standard("ccsds-k7")``."""
        from repro_torch.codes.registry import get_code

        code = get_code(name)
        return cls(
            spec=code.spec,
            rho=rho,
            precision=precision,
            use_kernel=use_kernel,
            pack_survivors=pack_survivors,
            decision_depth=decision_depth,
            puncture=code.puncture,
            termination=code.termination,
            one_pass=one_pass,
            time_tile=time_tile,
            block_frames=block_frames,
            time_parallel=time_parallel,
            transfer_tile=transfer_tile,
            validate_inputs=validate_inputs,
            sanitize=sanitize,
            device=device,
        )

    @classmethod
    def from_config(
        cls,
        vcfg,
        precision: Optional[AcsPrecision] = None,
        use_kernel: bool = True,
        decision_depth: Optional[int] = None,
        one_pass: Optional[bool] = None,
        device=None,
    ) -> "ViterbiDecoder":
        """Build from a ``configs.viterbi_k7.ViterbiConfig`` (the one
        config -> decoder mapping; ``serve/step.py`` delegates here).  A
        config naming a registry standard (``vcfg.code``) inherits its
        puncture pattern and termination, and its spec must be that
        standard's; the kernel-geometry fields (``time_tile``,
        ``block_frames``, ``time_parallel``, ``transfer_tile``) and
        ``pack_survivors`` carry over.  ``use_kernel`` defaults to True
        (the reference's default is False); ``one_pass`` (None: follow
        ``use_kernel``, as the reference does) and ``device`` (None: the
        card) are the port's additions."""
        puncture, termination = None, "zero"
        code_name = getattr(vcfg, "code", None)
        if code_name:
            from repro_torch.codes.registry import get_code

            code = get_code(code_name)
            if code.spec != vcfg.spec:
                raise ValueError(
                    f"config spec {vcfg.spec} != standard {code_name} "
                    f"spec {code.spec}"
                )
            puncture, termination = code.puncture, code.termination
        return cls(
            spec=vcfg.spec,
            rho=vcfg.rho,
            precision=precision or vcfg.precision,
            use_kernel=use_kernel,
            pack_survivors=getattr(vcfg, "pack_survivors", False),
            decision_depth=decision_depth or DEFAULT_DECISION_DEPTH,
            puncture=puncture,
            termination=termination,
            time_tile=getattr(vcfg, "time_tile", None),
            block_frames=getattr(vcfg, "block_frames", None),
            time_parallel=getattr(vcfg, "time_parallel", None),
            transfer_tile=getattr(vcfg, "transfer_tile", None),
            one_pass=one_pass,
            device=device,
        )

    def _harden(self, llrs, where: str = "decoder"):
        """Validate (or sanitize) one LLR tensor at an entry point: strict
        mode raises :class:`InvalidInputError` on NaN/Inf,
        ``sanitize=True`` clamps and counts."""
        if not self.validate_inputs:
            return llrs
        llrs, n_bad = validate_llrs(llrs, sanitize=self.sanitize, where=where)
        self.sanitized_total += n_bad
        return llrs

    def depunctured(self, llrs, stream: bool = False) -> torch.Tensor:
        """The LLRs as float32 on the decoder's device, with zero-LLR
        erasures re-inserted when this decoder is punctured.

        Punctured inputs are the serial kept-LLR stream: (F, Lp) for the
        batch entry points, (Lp,) for single-stream ones.  Already
        depunctured (..., n, beta) inputs pass through unchanged, so
        upstream stages may depuncture once themselves.
        """
        llrs = torch.as_tensor(llrs, device=self.device).to(torch.float32)
        shaped_ndim = 2 if stream else 3
        if self.puncture is None or llrs.dim() == shaped_ndim:
            return llrs
        from repro_torch.codes.puncture import depuncture

        return depuncture(llrs, self.puncture)

    def _headroom_check(self, llrs) -> None:
        """``batch_headroom_check`` of an un-chunked decode of shaped
        ``llrs`` when inputs are validated and the carry is not
        renormalised (one host read of max|llr|)."""
        if self.validate_inputs and not self.precision.renorm:
            batch_headroom_check(
                self.precision,
                -(-llrs.shape[1] // self.rho),
                host_read(llrs.abs().max()) if llrs.numel() else 0.0,
                self.rho,
                llrs.shape[2],
            )

    def _check_shaped(self, llrs, where: str) -> None:
        if llrs.dim() != 3 or llrs.shape[2] != self.spec.beta:
            raise InvalidInputError(
                f"{where} expects (F, n, beta={self.spec.beta}) LLRs, "
                f"got shape {tuple(llrs.shape)}",
                reason="shape",
            )

    def _time_parallel_tile(
        self, n_frames: int, t_steps: int, time_parallel: Optional[bool]
    ) -> Optional[int]:
        """Transfer tile of the time-parallel path for this shape, or None
        to stay sequential: the per-call choice beats the decoder's, then
        ``time_parallel_plan`` (tile grid, and on auto this device's
        budget)."""
        resolved = (
            self.time_parallel if time_parallel is None else time_parallel
        )
        return time_parallel_plan(
            n_frames, t_steps, self.spec.n_states, resolved,
            self.transfer_tile, device_underfill_rows(self.device),
        )

    def decode_batch(
        self,
        llrs,
        initial_state: Optional[int] = 0,
        final_state: Optional[int] = None,
        termination: Optional[str] = None,
        time_parallel: Optional[bool] = None,
    ) -> torch.Tensor:
        """One-shot decode of independent frames.

        llrs: (F, n, beta), or the serial punctured stream (F, Lp) when
        the decoder carries a puncture pattern; a tensor or array, moved
        to the decoder's device as float32.  With
        ``termination="tailbiting"`` (or a tail-biting standard) the
        frames decode through ``decode_tailbiting`` and
        initial/final_state are ignored.  n not divisible by rho is
        zero-LLR padded internally (information-free) unless a
        final-state pin would land on the padding.  Returns (F, n) int32
        bits on the decoder's device.

        ``time_parallel`` (None: the decoder's choice, which defaults to
        auto) decodes through the time-parallel path — the same bits,
        sequential depth O(tile + log2 tiles) instead of n/rho — on
        request, or on auto when the frames underfill the card.
        """
        term = termination or self.termination
        if term == "tailbiting":  # opens its own ``decode`` root
            return self.decode_tailbiting(llrs, time_parallel=time_parallel)[0]
        with stage("decode", device=self.device) as sp:
            with stage("front_door", device=self.device):
                llrs = self.depunctured(llrs)
                self._check_shaped(llrs, "decode_batch")
                llrs = self._harden(llrs)
                n = llrs.shape[1]
                self._headroom_check(llrs)
            F = llrs.shape[0]
            pad = (-n) % self.rho
            if pad:
                if final_state is not None:
                    raise ValueError(
                        f"final_state requires n divisible by rho={self.rho}; "
                        f"got n={n} (the pin would land on padded stages)"
                    )
                llrs = tnf.pad(llrs, (0, 0, 0, pad))
            tp_tile = self._time_parallel_tile(
                F, (n + pad) // self.rho, time_parallel
            )
            path = "time_parallel" if tp_tile is not None else "batch"
            sp.set(path=path)
            _count_dispatch(path)
            if tp_tile is not None:
                from .timeparallel import decode_time_parallel

                out = decode_time_parallel(
                    llrs,
                    self.spec,
                    rho=self.rho,
                    initial_state=initial_state,
                    final_state=final_state,
                    precision=self.precision,
                    transfer_tile=tp_tile,
                    use_kernel=self.use_kernel,
                    pack_survivors=self.pack_survivors,
                    device=self.device,
                )
            else:
                out = decode_frames(
                    llrs,
                    self.spec,
                    rho=self.rho,
                    initial_state=initial_state,
                    final_state=final_state,
                    precision=self.precision,
                    use_kernel=self.use_kernel,
                    pack_survivors=self.pack_survivors,
                    device=self.device,
                )
            return out[:, :n] if pad else out

    # -- tiled stream (stateless, latency-optimal) ------------------------

    def default_tiled_config(
        self, base: Optional[TiledDecoderConfig] = None
    ) -> TiledDecoderConfig:
        """The tiling this decoder picks by itself: ``base`` (or the
        library default), with the overlap stretched by the puncture
        expansion and kept on the rho grid."""
        base = base or TiledDecoderConfig(rho=self.rho)
        if self.puncture is None:
            return base
        v = int(base.overlap * self.puncture.expansion)
        v += (-v) % self.rho
        return TiledDecoderConfig(
            frame_len=base.frame_len, overlap=v, rho=self.rho
        )

    def decode_stream_tiled(
        self, llrs, cfg: Optional[TiledDecoderConfig] = None
    ) -> torch.Tensor:
        """Overlapping-window decode of one stream (paper §III): (n, beta),
        or the serial punctured (Lp,) stream for a punctured decoder;
        returns (n,) int32 bits on the decoder's device.  Without a
        ``cfg``, a punctured decoder stretches the default overlap by
        the puncture expansion (``default_tiled_config``)."""
        if self.termination == "tailbiting":
            raise ValueError(
                "tiled stream decode assumes an open (non-circular) "
                "trellis; use decode_batch/decode_tailbiting per frame"
            )
        llrs = self._harden(self.depunctured(llrs, stream=True))
        cfg = cfg or self.default_tiled_config()
        if cfg.rho != self.rho:
            raise ValueError(f"cfg.rho={cfg.rho} != decoder rho={self.rho}")
        _count_dispatch("tiled")
        return tiled_decode_stream(
            llrs,
            self.spec,
            cfg,
            precision=self.precision,
            use_kernel=self.use_kernel,
            pack_survivors=self.pack_survivors,
            one_pass=self.one_pass,
            time_tile=self.time_tile,
            block_frames=self.block_frames,
            time_parallel=self.time_parallel,
            transfer_tile=self.transfer_tile,
            device=self.device,
        )

    # -- stateful chunked streaming (throughput-optimal) ------------------

    def init_stream_state(
        self,
        n_frames: int,
        initial_state: Optional[int] = None,
        decision_depth: Optional[int] = None,
    ) -> StreamState:
        """Fresh state for F parallel streams decoded chunk by chunk."""
        depth = decision_depth or self.decision_depth
        if depth % self.rho:
            raise ValueError(
                f"decision_depth={depth} not divisible by rho={self.rho}"
            )
        S = self.spec.n_states
        lam = init_metric(n_frames, S, initial_state, device=self.device)
        hist = torch.zeros(
            (depth // self.rho, n_frames, ring_words(S, self.ring_packed)),
            dtype=ring_dtype(self.ring_packed), device=self.device,
        )
        return StreamState(lam=lam, hist=hist, pos=0)

    def _one_pass_tile(self, t_steps: int, d_steps: int) -> Optional[int]:
        """K2's time tile for a (t_steps, d_steps) chunk, or None for the
        two-pass step (the shared ``one_pass_time_tile`` rule)."""
        if not self.one_pass:
            return None
        return one_pass_time_tile(
            d_steps,
            t_steps,
            self.spec.n_states,
            self.ring_packed,
            self.time_tile,
            self.block_frames,
        )

    def decode_chunk(
        self, state: StreamState, llrs
    ) -> Tuple[StreamState, torch.Tensor]:
        """Consume one (F, c, beta) LLR chunk, c divisible by rho, and emit
        the decisions that became final.

        Returns (new_state, bits (F, m*rho)) for the m chunk steps whose
        decisions now have >= decision_depth stages of lookahead: empty
        during warm-up, (F, c) once pos >= decision_depth.  Across
        ``decode_chunk`` calls and ``flush_stream`` every stage is emitted
        once, in order.
        """
        llrs = self._harden(
            torch.as_tensor(llrs, device=self.device).to(torch.float32),
            where="stream",
        )
        F, c, _ = llrs.shape
        if F != state.n_frames:
            raise ValueError(f"state has {state.n_frames} frames, got {F}")
        blocks = blocks_from_llrs(llrs, self.rho)
        hist, lam, bits = self._dispatch_chunk(state.hist, state.lam, blocks)
        T = c // self.rho
        lam = self._guard_carry(lam, state.pos + T, T)
        n_valid = _window_valid(state.pos, T, state.depth_steps)
        out = bits[:, (T - n_valid) * self.rho:] if n_valid else bits[:, :0]
        return StreamState(lam=lam, hist=hist, pos=state.pos + T), out

    def _guard_carry(self, lam, pos: int, t_chunk: int):
        """Between chunks the carry is visible: for no-renorm precisions,
        observe it on the guard's cadence and renormalise (a per-frame
        max subtraction, which the traceback does not see) before the
        carry dtype runs out of headroom.  Inert with renorm on."""
        guard = self.renorm_guard
        if guard is None or not guard.due(pos, t_chunk):
            return lam
        lam, _ = guard.observe(lam, t_chunk=t_chunk)
        return lam

    def _dispatch_chunk(self, hist, lam, blocks):
        """(hist, lam, blocks) -> (hist', lam', window bits (F, T*rho)) for
        the T oldest window steps, through K2 or the two-pass step by the
        one-pass rule: the single dispatch point under ``decode_chunk``
        and ``decode_chunk_multi``."""
        tt = self._one_pass_tile(blocks.shape[0], hist.shape[0])
        _count_dispatch("chunk_one_pass" if tt else "chunk_two_pass")
        if tt:
            return _chunk_step_fused(
                hist, lam, blocks, self.tables, self.precision, tt,
                self.ring_packed,
            )
        return _chunk_step(
            hist, lam, blocks, self.tables, self.precision,
            self.use_kernel, self.ring_packed,
        )

    def decode_chunk_multi(self, states, chunks):
        """Advance several independent stream states in one dispatch.

        ``states`` are StreamStates of this decoder (one decision depth);
        ``chunks`` the matching (f_i, c, beta) LLR chunks, all of c
        stages.  They are stacked on the frame axis, run through one
        ``_dispatch_chunk`` and split back; each state's window is sliced
        by its own position, so every session emits what it would emit
        alone.  Returns (new_states, outs), outs[i] (f_i, m_i*rho).
        """
        if not states:
            return [], []
        if len(states) != len(chunks):
            raise ValueError(f"{len(states)} states but {len(chunks)} chunks")
        depths = {s.depth_steps for s in states}
        if len(depths) != 1:
            raise ValueError(f"mixed decision depths {sorted(depths)}")
        chunks = [
            torch.as_tensor(ch, device=self.device).to(torch.float32)
            for ch in chunks
        ]
        steps = {ch.shape[1] for ch in chunks}
        if len(steps) != 1:
            raise ValueError(f"mixed chunk lengths {sorted(steps)}")
        for s, ch in zip(states, chunks):
            if ch.shape[0] != s.n_frames:
                raise ValueError(
                    f"state has {s.n_frames} frames, chunk {ch.shape[0]}"
                )
        stacked = self._harden(torch.cat(chunks, dim=0), where="stream")
        blocks = blocks_from_llrs(stacked, self.rho)
        hist = torch.cat([s.hist for s in states], dim=1)
        lam = torch.cat([s.lam for s in states], dim=0)
        hist2, lam2, bits = self._dispatch_chunk(hist, lam, blocks)
        T = steps.pop() // self.rho
        D = depths.pop()
        if self.renorm_guard is not None and any(
                self.renorm_guard.due(s.pos + T, T) for s in states):
            lam2, _ = self.renorm_guard.observe(lam2, t_chunk=T)
        new_states, outs, off = [], [], 0
        for s in states:
            f = s.n_frames
            b = bits[off:off + f]
            n_valid = _window_valid(s.pos, T, D)
            outs.append(b[:, (T - n_valid) * self.rho:] if n_valid else b[:, :0])
            new_states.append(StreamState(
                lam=lam2[off:off + f], hist=hist2[:, off:off + f],
                pos=s.pos + T,
            ))
            off += f
        return new_states, outs

    def flush_stream(
        self, state: StreamState, final_state: Optional[int] = None
    ) -> torch.Tensor:
        """End of stream: commit the decisions still inside the ring.

        Returns (F, min(pos, depth)*rho) bits.  With ``final_state`` the
        traceback is pinned (tail-flushed streams); otherwise it starts
        from the per-frame argmax metric, as decode_batch does.
        """
        bits = _flush_step(state.hist, state.lam, self.tables, final_state)
        valid = min(state.pos, state.depth_steps)
        return bits[:, (state.depth_steps - valid) * self.rho:]

    def decode_stream_chunked(
        self,
        llrs,
        chunk_len: int = 4096,
        initial_state: Optional[int] = None,
        final_state: Optional[int] = None,
        decision_depth: Optional[int] = None,
    ) -> torch.Tensor:
        """Chunk (F, n, beta) streams through the stateful path and return
        the whole (F, n) int32 decision array on the decoder's device.

        The last chunk is the (shorter) remainder, so at most rho-1
        trailing stages are zero-LLR padded, and their decisions are cut
        off.  ``final_state`` pins the traceback at the last stage, so it
        is refused when that stage would be padding (n not a multiple of
        rho).  A punctured decoder also takes the serial (F, Lp) streams:
        the erasures are re-inserted up front, and the decision depth
        was stretched by the puncture expansion at construction.
        """
        if self.termination == "tailbiting":
            raise ValueError(
                "chunked streaming assumes an open trellis; tail-biting "
                "frames decode whole via decode_batch/decode_tailbiting"
            )
        llrs = self.depunctured(llrs)
        F, n, _ = llrs.shape
        c = chunk_len - (chunk_len % self.rho) or self.rho
        pad = (-n) % self.rho
        if pad and final_state is not None:
            raise ValueError(
                f"final_state requires n divisible by rho={self.rho}; "
                f"got n={n} (the pin would land on padded stages)"
            )
        state = self.init_stream_state(
            F, initial_state=initial_state, decision_depth=decision_depth
        )
        if pad:
            llrs = tnf.pad(llrs, (0, 0, 0, pad))
        outs = []
        for lo in range(0, n, c):
            state, bits = self.decode_chunk(state, llrs[:, lo:lo + c])
            outs.append(bits)
        outs.append(self.flush_stream(state, final_state=final_state))
        return torch.cat(outs, dim=1)[:, :n]

    def decode_tailbiting(
        self,
        llrs,
        max_iters: Optional[int] = None,
        time_parallel: Optional[bool] = None,
    ):
        """Wrap-around (WAVA) decode of tail-biting frames.

        llrs as in ``decode_batch``.  Returns (bits (F, n) int32,
        converged (F,) bool) on the decoder's device.  Frame lengths not
        divisible by rho fall back to radix-2 tables, since the circular
        trellis cannot be padded.  With the time-parallel plan (on
        request, or on auto when the frames underfill the card) each
        circulation runs the transfer-matrix scan.  The call is one
        ``decode`` stage (``path="wava"``) holding ``front_door`` and
        ``wava``, reached from here or from ``decode_batch``.
        """
        from repro_torch.codes.tailbiting import DEFAULT_WAVA_ITERS, wava_decode

        with stage("decode", device=self.device, path="wava"):
            with stage("front_door", device=self.device):
                llrs = self.depunctured(llrs)
                self._check_shaped(llrs, "decode_tailbiting")
                llrs = self._harden(llrs)
            F, n = llrs.shape[0], llrs.shape[1]
            tables = (
                self.tables if n % self.rho == 0
                else build_acs_tables(self.spec, 1)
            )
            tp_tile = self._time_parallel_tile(F, n // tables.rho, time_parallel)
            _count_dispatch("wava")
            return wava_decode(
                llrs,
                tables,
                precision=self.precision,
                use_kernel=self.use_kernel,
                pack_survivors=self.pack_survivors,
                max_iters=max_iters or DEFAULT_WAVA_ITERS,
                time_parallel=tp_tile is not None,
                transfer_tile=tp_tile,
                device=self.device,
            )

    # -- sharded ----------------------------------------------------------

    def decode_sharded(
        self,
        llrs,
        mesh=None,
        initial_state: Optional[int] = 0,
        final_state: Optional[int] = None,
    ) -> torch.Tensor:
        """``decode_batch`` on the sequential path with the frame axis
        split over the shards of ``mesh``
        (``distributed.decoder.sharded_decode_frames``); None is every
        card, or one shard on this decoder's device when it is the CPU.
        Punctured serial input is depunctured first; tail-biting frames
        are not sharded, as in the reference.  Returns (F, n) int32 bits
        on the first shard's device."""
        from repro_torch.distributed.decoder import (
            frame_mesh,
            sharded_decode_frames,
        )

        if self.termination == "tailbiting":
            raise NotImplementedError(
                "sharded tail-biting decode not implemented; shard "
                "frames manually over decode_tailbiting"
            )
        if mesh is None:
            mesh = frame_mesh(
                device=self.device if self.device.type == "cpu" else None
            )
        _count_dispatch("sharded")
        return sharded_decode_frames(
            self._harden(self.depunctured(llrs)),
            self.spec,
            rho=self.rho,
            mesh=mesh,
            initial_state=initial_state,
            final_state=final_state,
            precision=self.precision,
            use_kernel=self.use_kernel,
            pack_survivors=self.pack_survivors,
        )

    # -- soft output --------------------------------------------------------

    def decode_soft(
        self,
        llrs,
        output: str = "llr",
        n_list: int = 4,
        initial_state: Optional[int] = 0,
        final_state: Optional[int] = None,
        termination: Optional[str] = None,
    ):
        """Soft-output decode of (F, n, beta) LLRs on the decoder's device.

        ``output`` selects:

          * ``"llr"``  — (F, n) f32 per-bit BCJR LLRs (positive = bit 0,
            the channel-LLR convention), through K3-LOGPROB when
            ``use_kernel``;
          * ``"bits"`` — (F, n) int32 MAP-per-bit hard decisions
            (``llr < 0``; they may differ from ``decode_batch``'s
            ML-sequence decisions where the channel is poor);
          * ``"list"`` — (bits (F, L, n) int32, metrics (F, L) f32), the
            top-``n_list`` list-Viterbi paths, metric-sorted and
            distinct; L=1 is bit-exact with ``decode_batch`` on the
            sequential path.

        Tail-biting frames go to the exact circular BCJR (llr, bits) or
        the WAVA list loop (list), with rho=1 tables for odd lengths;
        ``initial_state`` and ``final_state`` are then ignored, as in
        ``decode_batch``.  Open frames of a length not divisible by rho
        are zero-LLR padded, and a ``final_state`` pin on padded stages
        is refused.  Punctured serial streams (F, Lp) are depunctured
        first: the zero-LLR erasures carry no information in the log
        semiring either.
        """
        if output not in ("llr", "bits", "list"):
            raise ValueError(
                f"output must be 'llr', 'bits' or 'list', got {output!r}"
            )
        term = termination or self.termination
        with stage("decode", device=self.device) as sp:
            with stage("front_door", device=self.device):
                llrs = self.depunctured(llrs)
                self._check_shaped(llrs, "decode_soft")
                llrs = self._harden(llrs)
                n = llrs.shape[1]
                self._headroom_check(llrs)
            if term == "tailbiting":
                tables = (
                    self.tables if n % self.rho == 0
                    else build_acs_tables(self.spec, 1)
                )
                if output == "list":
                    from .soft import wava_list_decode

                    sp.set(path="soft_list")
                    _count_dispatch("soft_list")
                    bits, metrics, _ = wava_list_decode(
                        llrs, tables, n_list, self.precision,
                        device=self.device,
                    )
                    return bits, metrics
                from .soft import bcjr_circular_llrs

                sp.set(path="soft")
                _count_dispatch("soft")
                out = bcjr_circular_llrs(
                    llrs, tables, self.precision, use_kernel=self.use_kernel,
                    device=self.device,
                )
                return out if output == "llr" else (out < 0).to(torch.int32)
            pad = (-n) % self.rho
            if pad:
                if final_state is not None:
                    raise ValueError(
                        f"final_state requires n divisible by rho={self.rho}; "
                        f"got n={n} (the pin would land on padded stages)"
                    )
                llrs = tnf.pad(llrs, (0, 0, 0, pad))
            if output == "list":
                from .soft import list_decode

                sp.set(path="soft_list")
                _count_dispatch("soft_list")
                bits, metrics = list_decode(
                    llrs,
                    self.spec,
                    n_list=n_list,
                    rho=self.rho,
                    initial_state=initial_state,
                    final_state=final_state,
                    precision=self.precision,
                    device=self.device,
                )
                return (bits[:, :, :n] if pad else bits), metrics
            from .soft import bcjr_llrs

            sp.set(path="soft")
            _count_dispatch("soft")
            out = bcjr_llrs(
                llrs,
                self.spec,
                rho=self.rho,
                initial_state=initial_state,
                final_state=final_state,
                precision=self.precision,
                transfer_tile=self.transfer_tile,
                use_kernel=self.use_kernel,
                device=self.device,
            )
            out = out[:, :n] if pad else out
            return out if output == "llr" else (out < 0).to(torch.int32)
