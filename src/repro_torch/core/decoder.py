"""Decoder front door: ``ViterbiDecoder``.

This slice ports the batch entry point, ``decode_batch``: one-shot
decode of independent zero-terminated frames (the paper's §IX workload)
on the sequential path, with the forward pass in K1 and a plain PyTorch
traceback.  The other entry points of the reference (tail-biting,
punctured input, soft output, streaming, sharding, time-parallel decode)
belong to later slices and raise ``NotImplementedError`` naming theirs.

Entry points run on the card: ``device=None`` resolves to ``"cuda"`` and
raises where there is none; the CPU is used only when asked for.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tnf

from .backend import resolve_device
from .kernel_geometry import time_parallel_plan
from .trellis import CodeSpec, build_acs_tables
from .validate import (
    InvalidInputError,
    RenormGuard,
    batch_headroom_check,
    validate_llrs,
)
from .viterbi import AcsPrecision, decode_frames

__all__ = ["ViterbiDecoder", "InvalidInputError"]


def _count_dispatch(path: str) -> None:
    """Path-selection counter in the library-wide default registry (a
    no-op ``NullRegistry`` until observability installs a real one)."""
    from repro_torch.obs.metrics import default_registry

    default_registry().counter(
        "decoder_dispatch_total",
        "ViterbiDecoder dispatches by selected decode path",
    ).inc(1, path=path)


def _later(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} is not ported yet: it belongs to the {slice_name} slice "
        "of the PyTorch/CUDA port"
    )


class ViterbiDecoder:
    """One front door per (code, radix, precision, device).

    The fused-ACS tables are built once at construction.  ``use_kernel``
    (default True) runs the forward pass in K1 — the CUDA kernel on the
    card, its plain version on the CPU; ``use_kernel=False`` runs the
    plain scan with ``split_dot`` honoured.
    """

    def __init__(
        self,
        spec: CodeSpec,
        rho: int = 2,
        precision: Optional[AcsPrecision] = None,
        use_kernel: bool = True,
        pack_survivors: bool = False,
        puncture=None,  # codes.PuncturePattern | None
        termination: str = "zero",
        time_parallel: Optional[bool] = None,
        validate_inputs: bool = True,
        sanitize: bool = False,
        device=None,
    ):
        if termination not in ("zero", "tailbiting"):
            raise ValueError(f"unknown termination {termination!r}")
        if puncture is not None and puncture.beta != spec.beta:
            raise ValueError(
                f"puncture beta={puncture.beta} != code beta={spec.beta}"
            )
        if time_parallel:
            _later("time-parallel decode (K3)", "time-parallel")
        self.device = resolve_device(device)
        self.spec = spec
        self.rho = rho
        self.tables = build_acs_tables(spec, rho)
        self.precision = precision or AcsPrecision()
        self.use_kernel = use_kernel
        self.pack_survivors = pack_survivors
        self.puncture = puncture
        self.termination = termination
        self.time_parallel = time_parallel
        # input hardening: validate every entry point (strict raise, or
        # clamp-and-count with sanitize=True); no-renorm precisions get
        # the renorm-cadence guard the streaming slice will consult
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
        time_parallel: Optional[bool] = None,
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
            puncture=code.puncture,
            termination=code.termination,
            time_parallel=time_parallel,
            validate_inputs=validate_inputs,
            sanitize=sanitize,
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

    def depunctured(self, llrs):
        """Pass (F, n, beta) LLRs of an unpunctured decoder through."""
        if self.puncture is not None:
            _later("depuncturing", "standard-codes")
        return llrs

    def decode_batch(
        self,
        llrs,
        initial_state: Optional[int] = 0,
        final_state: Optional[int] = None,
        termination: Optional[str] = None,
        time_parallel: Optional[bool] = None,
    ) -> torch.Tensor:
        """One-shot decode of independent frames.

        llrs: (F, n, beta), a tensor or array; it is moved to the
        decoder's device as float32.  n not divisible by rho is zero-LLR
        padded internally (information-free) unless a final-state pin
        would land on the padding.  Returns (F, n) int32 bits on the
        decoder's device.
        """
        term = termination or self.termination
        if term == "tailbiting":
            _later("tail-biting (WAVA) decode", "standard-codes")
        llrs = self.depunctured(
            torch.as_tensor(llrs, device=self.device).to(torch.float32)
        )
        if llrs.dim() != 3 or llrs.shape[2] != self.spec.beta:
            raise InvalidInputError(
                f"decode_batch expects (F, n, beta={self.spec.beta}) LLRs, "
                f"got shape {tuple(llrs.shape)}",
                reason="shape",
            )
        llrs = self._harden(llrs)
        F, n, _ = llrs.shape
        if self.validate_inputs and not self.precision.renorm:
            batch_headroom_check(
                self.precision,
                -(-n // self.rho),
                float(llrs.abs().max()) if llrs.numel() else 0.0,
                self.rho,
                llrs.shape[2],
            )
        pad = (-n) % self.rho
        if pad:
            if final_state is not None:
                raise ValueError(
                    f"final_state requires n divisible by rho={self.rho}; "
                    f"got n={n} (the pin would land on padded stages)"
                )
            llrs = tnf.pad(llrs, (0, 0, 0, pad))
        resolved = self.time_parallel if time_parallel is None else time_parallel
        if resolved or time_parallel_plan(
            F, (n + pad) // self.rho, self.spec.n_states, resolved
        ) is not None:
            _later("time-parallel decode (K3)", "time-parallel")
        _count_dispatch("batch")
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

    # -- entry points of later slices -------------------------------------

    def decode_tailbiting(self, llrs, max_iters=None, time_parallel=None):
        _later("tail-biting (WAVA) decode", "standard-codes")

    def decode_soft(self, llrs, output: str = "llr", **kwargs):
        _later("soft-output decode (BCJR, list-Viterbi)", "soft-output")

    def decode_stream_tiled(self, llrs, cfg=None):
        _later("tiled stream decode", "streaming")

    def init_stream_state(self, n_frames: int, initial_state=None,
                          decision_depth=None):
        _later("chunked streaming", "streaming")

    def decode_chunk(self, state, llrs):
        _later("chunked streaming", "streaming")

    def decode_stream_chunked(self, llrs, chunk_len: int = 4096, **kwargs):
        _later("chunked streaming", "streaming")
