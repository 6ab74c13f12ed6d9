"""Multi-tenant serving engine: dynamic batch assembly over the
``ViterbiDecoder`` front door, the port of the reference's
``serve/engine.py``.

The decode paths below the engine decode dense (F, T) batches; traffic
is ragged requests of mixed codes and service classes.  The
``DecodeEngine`` turns one into the other:

  * **cell bucketing** — each request goes to a cell keyed by (code, SLO
    class, length rung, framing): lengths round up a power-of-two ladder
    (``kernel_geometry.pick_cell_length``), frame counts to a power-of-two
    rung (``pick_cell_frames``).  Padding is trailing zero LLRs,
    information-free stages: the argmax-front traceback reaches a true
    end state of the global-max metric, so the decoded prefix is the bits
    of the unpadded frame.  Tail-biting frames, and frames declared
    ``flushed``, go to exact-length cells.
  * **batch assembly** — per-cell FIFO queues flush when ``max_batch``
    requests wait or the oldest has waited ``max_wait[slo]`` (every entry
    point takes an explicit ``now``, so a virtual clock works), with
    backpressure past ``max_pending``.
  * **routing** (``_pick_path``): soft-class cells -> ``decode_soft``
    (K3-LOGPROB); tail-biting -> WAVA (K1 a circulation); latency cells
    that underfill the device (``backend.device_underfill_rows``) ->
    time-parallel ``decode_batch`` (K3 + K1); throughput cells of at least
    ``STREAM_MIN_STEPS`` steps on a kernel-enabled engine -> one-pass
    ``decode_stream_chunked`` (K2); cells that fill a given
    ``FrameMesh`` -> ``decode_sharded`` (K1 once a shard); the rest ->
    sequential ``decode_batch`` (K1).  Zero-terminated frames pin the
    initial state to 0, flushed frames the final state too.
  * **callable cache** — decode callables are cached per (code, path, F
    rung, length rung, flushed), with hit and miss counters
    (``stats()["jit_cache"]``, the reference's name and numbers; nothing
    is compiled here, the kernels are built once per process).
  * **sessions** — chunked-streaming tenants keep their ``StreamState``
    (on the decoder's device) in an LRU table; the head chunks of
    sessions of one code and chunk length fuse into one
    ``decode_chunk_multi`` dispatch (K2, or K1 and the traceback).
    Overflow evicts the least recently used session: its pending chunks
    are decoded, its ring flushed, its tail kept for ``evicted_tail``.
  * **fault tolerance** — every dispatch runs under a guard: injected or
    real faults are retried with bounded backoff, then degraded down
    ``DEGRADATION_LADDER`` (every rung decodes the same bits); device
    failures shrink the mesh (``distributed.decoder.replan_mesh``);
    requests that exhaust the ladder get a typed error on their ticket;
    requests past their deadline are shed.  Session tables checkpoint to
    ``checkpoint_dir`` (``runtime.checkpoint``) and restore bit for bit.
  * **scrubbing** — sampled batch dispatches get a re-encode syndrome
    check per frame (``verify.scrub``); flags are confirmed by a shadow
    re-decode on another rung, and confirmed corruption fails the ticket
    with ``sdc_detected`` and quarantines the attributed device.

One departure from the reference's "the engine never crashes": a
``kernels.viterbi_acs.KernelError`` (a kernel that could not be built or
launched, or any exception of a kernel wrapper on card tensors, its
refusals included) is re-raised untouched by every guard, out of
``poll`` and ``drain``: no retry, no degraded rung, no ticket error, no
false alarm.  A failed kernel on the card is a fault of the
installation, and a rung that ran the plain version in its place would
hide it; so an engine on the card also has no plain rung
(``PLAIN_RUNGS``): its stream cells degrade to batch (K1) only.

Tensors: each cell is assembled on the host and copied to the decoder's
device once; the device wait is the ``.cpu()`` copy of the result, and
the ``engine.device_wait`` span and ``engine_dispatch_seconds`` close
after it.  With the recorder on, each dispatch span carries
``obs.profile.dispatch_profile``'s modelled bytes, operations, depth
and roofline terms, priced on the H100, and after the wait the achieved
fractions of that wall, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backend import device_underfill_rows, resolve_device
from repro_torch.core.decoder import ViterbiDecoder
from repro_torch.core.kernel_geometry import (
    ENGINE_MIN_CELL,
    pick_cell_frames,
    pick_cell_length,
    time_parallel_plan,
)
from repro_torch.core.validate import InvalidInputError, validate_llrs
from repro_torch.kernels.viterbi_acs import KernelError
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import dispatch_profile
from repro_torch.obs.trace import NullRecorder, SpanRecorder
from repro_torch.runtime.chaos import DeviceFailure, DispatchTimeout
from repro_torch.runtime.failure import QuarantineRecord, RetryPolicy
from repro_torch.verify.scrub import SdcScrubber

__all__ = [
    "SLO_CLASSES",
    "DEFAULT_MAX_WAIT",
    "STREAM_MIN_STEPS",
    "DEGRADATION_LADDER",
    "PLAIN_RUNGS",
    "DecodeRequest",
    "Ticket",
    "DecodeEngine",
]

SLO_CLASSES = ("latency", "throughput", "soft")

# max batch-assembly wait per SLO class, seconds: latency cells flush an
# order of magnitude sooner than throughput cells, which trade wait for
# fill; soft cells batch like throughput traffic
DEFAULT_MAX_WAIT = {"latency": 0.001, "throughput": 0.010, "soft": 0.010}

# throughput cells of at least this many radix steps take the one-pass
# streaming route (K2) on a kernel-enabled engine; shorter ones stay on
# the sequential batch route
STREAM_MIN_STEPS = 4096

# the degradation ladder: a path that keeps faulting past its retry
# budget falls to the next rung.  Every rung decodes the same bits.
# "stream_xla" is the reference's name for the chunked stream on a
# decoder without kernels (here the plain PyTorch versions on the
# decoder's device); "batch" is the sequential decode every code has.
# WAVA, batch, soft and session dispatches have no other rung: they
# retry in place, then fail their tickets with a typed error.  An engine
# on the card skips the rungs in PLAIN_RUNGS (``DecodeEngine._ladder``):
# every rung it degrades to still runs a kernel.
DEGRADATION_LADDER = {
    "sharded": ("sharded", "batch"),
    "stream": ("stream", "stream_xla", "batch"),
    "time_parallel": ("time_parallel", "batch"),
    "wava": ("wava",),
    "batch": ("batch",),
    "soft": ("soft",),
}
PLAIN_RUNGS = frozenset({"stream_xla"})


@dataclasses.dataclass(frozen=True)
class DecodeRequest:
    """One tenant request: ragged LLRs, registry code, SLO class.

    ``llrs`` (host numpy) is (n, beta) stages for unpunctured and
    tail-biting codes, or the 1-D serial kept-LLR stream (Lp,) for
    punctured ones.  ``flushed`` declares that the frame ends in state 0
    (it carries its k-1 zero tail): flushed frames go to exact-length
    cells and decode with both ends pinned.
    ``deadline`` (engine clock) sheds the request with
    ``deadline_exceeded`` if its cell has not dispatched by then.
    """

    llrs: np.ndarray
    code: str = "ccsds-k7"
    slo: str = "throughput"
    flushed: bool = False
    deadline: Optional[float] = None


@dataclasses.dataclass
class Ticket:
    """Engine-side handle of a submitted request or session chunk.

    ``bits`` (np.int32 message bits) is filled when its batch decodes;
    soft-class tickets also get ``llrs`` (np.float32 posteriors), with
    ``bits`` their hard signs.  ``dropped`` marks backpressure rejects;
    ``error`` is a typed failure (``deadline_exceeded``,
    ``invalid_input:<reason>``, ``sdc_detected``,
    ``decode_failed:<ExceptionType>``).  A ticket ends done with bits,
    done with an error, or dropped.
    """

    id: int
    code: str
    slo: str
    submitted: float
    n_out: int
    done: bool = False
    dropped: bool = False
    bits: Optional[np.ndarray] = None
    llrs: Optional[np.ndarray] = None
    completed: Optional[float] = None
    cell: Optional[Tuple] = None
    path: Optional[str] = None
    error: Optional[str] = None
    retries: int = 0
    deadline: Optional[float] = None

    @property
    def sojourn(self) -> Optional[float]:
        return None if self.completed is None else (
            self.completed - self.submitted
        )


@dataclasses.dataclass
class _Session:
    """LRU-table entry of one chunked-streaming tenant."""

    sid: str
    code: str
    state: object  # core.decoder.StreamState, on the decoder's device
    pending: collections.deque  # of (Ticket, (1, c, beta) device chunk)
    last_used: float
    consumed_steps: int = 0


class DecodeEngine:
    """Multi-tenant decode engine with dynamic batch assembly (module
    docstring).  The parameters are the reference's, plus ``device``:

    max_batch        : frame cap of an assembled batch (and of the rungs).
    max_wait         : per-SLO assembly deadline, seconds of the clock
                       that ``now`` carries.
    max_pending      : queue depth past which ``submit`` drops.
    use_kernel       : the decoders' kernels (default True); with them,
                       throughput cells of >= ``STREAM_MIN_STEPS`` steps
                       take the stream route.  The reference's default is
                       False; on the CPU the kernels' plain versions run.
    precision        : ``AcsPrecision`` of every per-code decoder.
    decision_depth   : streaming decision depth of sessions.
    session_capacity : LRU session-table bound; overflow evicts.
    mesh             : optional ``distributed.decoder.FrameMesh``; cells
                       whose frame rung fills it take the sharded route.
    underfill_rows   : time-parallel eligibility budget (None: the
                       device's, ``backend.device_underfill_rows``).
    min_cell         : bottom rung of the length ladder.
    registry         : ``obs.MetricsRegistry`` backing every counter and
                       ``stats()`` (None: a private one).
    recorder         : ``obs.SpanRecorder`` for the request-lifecycle
                       spans (None: the zero-cost ``NullRecorder``).
    chaos            : optional ``runtime.chaos.ChaosInjector``, called
                       before every dispatch.
    retry            : ``runtime.failure.RetryPolicy`` or an int
                       max-retries shorthand.
    dispatch_timeout : injected straggler delays at or past it are
                       timeouts.
    monitor          : optional ``runtime.failure.HeartbeatMonitor``;
                       hosts it declares failed leave the mesh (host ids
                       are mesh ids).
    checkpoint_dir   : session-checkpoint directory (None: off).
    checkpoint_interval : engine-clock seconds between automatic
                       session checkpoints during ``poll``.
    scrub            : ``verify.scrub.SdcScrubber``, a sample-rate
                       shorthand, or None/0.0 (off: no extra calls).
    sanitize         : clamp-and-count non-finite input instead of
                       failing the ticket with ``invalid_input:non_finite``.
    device           : where every decoder runs (None: the card).
    """

    def __init__(
        self,
        max_batch: int = 64,
        max_wait: Optional[Dict[str, float]] = None,
        max_pending: int = 4096,
        use_kernel: bool = True,
        precision=None,
        decision_depth: Optional[int] = None,
        session_capacity: int = 128,
        mesh=None,
        underfill_rows: Optional[int] = None,
        min_cell: int = ENGINE_MIN_CELL,
        registry: Optional[MetricsRegistry] = None,
        recorder: Optional[SpanRecorder] = None,
        chaos=None,
        retry=None,
        dispatch_timeout: Optional[float] = None,
        monitor=None,
        checkpoint_dir=None,
        checkpoint_interval: Optional[float] = None,
        scrub=None,
        sanitize: bool = False,
        device=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_wait = dict(DEFAULT_MAX_WAIT, **(max_wait or {}))
        self.max_pending = max_pending
        self.use_kernel = use_kernel
        self.precision = precision
        self.decision_depth = decision_depth
        self.session_capacity = session_capacity
        self.mesh = mesh
        self.underfill_rows = underfill_rows
        self.min_cell = min_cell
        self.chaos = chaos
        if isinstance(retry, int):
            retry = RetryPolicy(max_retries=retry)
        self.retry = retry if retry is not None else RetryPolicy()
        self.dispatch_timeout = dispatch_timeout
        self.monitor = monitor
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = checkpoint_interval
        if scrub is None:
            scrub = SdcScrubber(rate=0.0)
        elif isinstance(scrub, (int, float)):
            scrub = SdcScrubber(rate=float(scrub))
        self.scrub = scrub
        self.sanitize = bool(sanitize)
        self._quarantined: set = set()
        # one QuarantineRecord per quarantined device, with its evidence
        self.quarantine_log: List[QuarantineRecord] = []
        self._last_ckpt: Optional[float] = None
        self._ckpt_steps = itertools.count()
        self._failed_devices: set = set()
        self._decoders: Dict[str, ViterbiDecoder] = {}
        self._plain_decoders: Dict[str, ViterbiDecoder] = {}
        self._queues: Dict[Tuple, collections.deque] = {}
        self._fns: Dict[Tuple, object] = {}
        self._sessions: "collections.OrderedDict[str, _Session]" = (
            collections.OrderedDict()
        )
        self._evicted: "collections.OrderedDict[str, np.ndarray]" = (
            collections.OrderedDict()
        )
        self._ids = itertools.count()
        self._sids = itertools.count()
        # bounded histories: the sojourn histograms keep a 4096-sample
        # window, batch_log the newest batches, unread eviction tails
        # expire oldest first
        self.batch_log: "collections.deque[dict]" = collections.deque(
            maxlen=1024
        )
        self._done_buffer: List[Ticket] = []  # completed out of band
        self.registry = registry if registry is not None else MetricsRegistry()
        self.recorder = recorder if recorder is not None else NullRecorder()
        r = self.registry
        self._m_requests = r.counter(
            "engine_requests_total",
            "requests by lifecycle event (submitted/completed/rejected)",
        )
        self._m_batches = r.counter(
            "engine_batches_total",
            "dispatched batches per (code, path, f, t) cell",
        )
        self._m_frames = r.counter(
            "engine_frames_total",
            "frames per dispatched cell, kind=real|pad",
        )
        self._m_elems = r.counter(
            "engine_llr_elems_total",
            "LLR elements moved per batch, kind=real|pad",
        )
        self._m_sessions = r.counter(
            "engine_sessions_total",
            "session lifecycle events (opened/closed/evicted; closed "
            "includes forced closes by eviction)",
        )
        self._m_jit = r.counter(
            "engine_jit_cache_total",
            "decode-callable cache lookups, event=hit|miss",
        )
        self._m_queue = r.gauge(
            "engine_queue_depth", "requests + session chunks waiting"
        )
        self._m_open_sessions = r.gauge(
            "engine_open_sessions", "sessions currently in the LRU table"
        )
        self._m_jit_entries = r.gauge(
            "engine_jit_cache_entries", "cached decode callables"
        )
        self._m_sojourn = r.histogram(
            "engine_sojourn_seconds",
            "submit -> complete sojourn per SLO class (engine clock)",
            window=4096,
        )
        self._m_dispatch = r.histogram(
            "engine_dispatch_seconds",
            "dispatch + device wait wall time per (code, path, f, t) "
            "cell (recorded only while tracing is enabled)",
        )
        self._m_faults = r.counter(
            "engine_faults_total",
            "dispatch faults observed, by kind (device_failure/timeout/"
            "slow/compile_error/error) and path",
        )
        self._m_retries = r.counter(
            "engine_retries_total",
            "dispatch retries by path (bounded per ladder rung)",
        )
        self._m_backoff = r.counter(
            "engine_backoff_seconds_total",
            "exponential-backoff budget accounted before retries "
            "(virtual: recorded, not slept, on the engine clock)",
        )
        self._m_degraded = r.counter(
            "engine_degraded_total",
            "degradation-ladder reroutes, labeled from -> to",
        )
        self._m_failover = r.counter(
            "engine_failover_total",
            "device failures absorbed by mesh re-planning",
        )
        self._m_ckpt = r.counter(
            "engine_checkpoints_total", "session-table checkpoints written"
        )
        self._m_scrub = r.counter(
            "engine_scrub_total",
            "SDC-scrubber events (sampled/frames/syndrome_flag/shadow/"
            "confirmed/false_alarm)",
        )
        self._m_quarantine = r.counter(
            "engine_quarantined_total",
            "devices quarantined after confirmed silent data corruption",
        )
        self._m_sanitized = r.counter(
            "decoder_input_sanitized_total",
            "input LLR samples repaired at the engine front door, by "
            "reason (nan/clamped)",
        )

    # -- decoders / callable cache ----------------------------------------

    def _decoder(self, code: str) -> ViterbiDecoder:
        """One ViterbiDecoder per registry code, built lazily and shared
        by every cell of that code (its device tables are made once)."""
        if code not in self._decoders:
            kw = {}
            if self.decision_depth is not None:
                kw["decision_depth"] = self.decision_depth
            self._decoders[code] = ViterbiDecoder.from_standard(
                code,
                precision=self.precision,
                use_kernel=self.use_kernel,
                device=self.device,
                **kw,
            )
        return self._decoders[code]

    def _plain_decoder(self, code: str) -> ViterbiDecoder:
        """The ``use_kernel=False`` twin of ``_decoder(code)``, behind the
        degraded "stream_xla" rung: the same tables and decision depth,
        the two-pass chunked path in plain PyTorch on the same device,
        which decodes the kernel path's bits."""
        if code not in self._plain_decoders:
            kw = {}
            if self.decision_depth is not None:
                kw["decision_depth"] = self.decision_depth
            self._plain_decoders[code] = ViterbiDecoder.from_standard(
                code,
                precision=self.precision,
                use_kernel=False,
                device=self.device,
                **kw,
            )
        return self._plain_decoders[code]

    def _underfill(self) -> int:
        if self.underfill_rows is not None:
            return self.underfill_rows
        return device_underfill_rows(self.device)

    def _pick_path(
        self, code: str, slo: str, f_cell: int, n_stages: int
    ) -> str:
        """The routing table, in the reference's order."""
        dec = self._decoder(code)
        steps = -(-n_stages // dec.rho)
        if slo == "soft":
            # decode_soft picks the circular or the open BCJR itself
            return "soft"
        if dec.termination == "tailbiting":
            return "wava"
        if slo == "latency":
            tile = time_parallel_plan(
                f_cell,
                steps,
                dec.spec.n_states,
                None,
                dec.transfer_tile,
                underfill_rows=self._underfill(),
            )
            if tile is not None:
                return "time_parallel"
        if slo == "throughput" and dec.one_pass and steps >= STREAM_MIN_STEPS:
            return "stream"
        if self.mesh is not None:
            from repro_torch.distributed.decoder import engine_dispatch_ready

            if engine_dispatch_ready(f_cell, self.mesh):
                return "sharded"
        return "batch"

    def _decode_fn(self, code: str, path: str, f_cell: int, l_cell: int,
                   flushed: bool = False):
        """Cached decode callable per (code, path, F rung, length rung,
        flushed), counted as a hit or a miss."""
        key = (code, path, f_cell, l_cell, flushed)
        if key in self._fns:
            self._m_jit.inc(1, event="hit")
            return self._fns[key]
        self._m_jit.inc(1, event="miss")
        dec = self._decoder(code)
        # zero-terminated frames start at state 0; the final end is pinned
        # only in cells of declared-flushed frames
        fin = 0 if flushed else None
        if path == "wava":
            fn = lambda llrs: dec.decode_tailbiting(llrs)[0]  # noqa: E731
        elif path == "soft":
            fn = lambda llrs: dec.decode_soft(  # noqa: E731
                llrs, output="llr", initial_state=0, final_state=fin,
            )
        elif path == "time_parallel":
            fn = lambda llrs: dec.decode_batch(  # noqa: E731
                llrs, initial_state=0, final_state=fin,
                time_parallel=True,
            )
        elif path == "stream":
            fn = lambda llrs: dec.decode_stream_chunked(  # noqa: E731
                llrs, initial_state=0, final_state=fin
            )
        elif path == "stream_xla":
            pdec = self._plain_decoder(code)
            fn = lambda llrs: pdec.decode_stream_chunked(  # noqa: E731
                llrs, initial_state=0, final_state=fin
            )
        elif path == "sharded":
            # late-binds self.mesh: a replanned mesh needs no new entry
            fn = lambda llrs: dec.decode_sharded(  # noqa: E731
                llrs, mesh=self.mesh, initial_state=0, final_state=fin
            )
        else:
            fn = lambda llrs: dec.decode_batch(  # noqa: E731
                llrs, initial_state=0, final_state=fin,
                time_parallel=False,
            )
        self._fns[key] = fn
        self._m_jit_entries.set(len(self._fns))
        return fn

    # -- request intake ----------------------------------------------------

    def _validate(self, req: DecodeRequest):
        """-> (llrs np.f32, n_stages, serial, l_input) or raises.

        Non-finite samples raise ``InvalidInputError(reason="non_finite")``
        (``submit`` makes it the ticket's error), or with ``sanitize`` are
        clamped and counted into this engine's registry."""
        from repro_torch.codes.registry import get_code

        code = get_code(req.code)
        if req.slo not in SLO_CLASSES:
            raise ValueError(
                f"unknown SLO class {req.slo!r}; known: {SLO_CLASSES}"
            )
        llrs = np.asarray(req.llrs, np.float32)
        if code.puncture is not None:
            if llrs.ndim != 1:
                raise ValueError(
                    f"{req.code} is punctured: requests carry the serial "
                    f"kept-LLR stream (Lp,), got shape {llrs.shape}"
                )
            llrs, _ = validate_llrs(
                llrs, sanitize=self.sanitize, where="engine",
                registry=self.registry,
            )
            n_stages = code.puncture.stages_for(llrs.shape[0])
            return llrs, n_stages, True, llrs.shape[0]
        if llrs.ndim != 2 or llrs.shape[1] != code.spec.beta:
            raise ValueError(
                f"{req.code} requests carry (n, beta={code.spec.beta}) "
                f"shaped LLRs, got shape {llrs.shape}"
            )
        llrs, _ = validate_llrs(
            llrs, sanitize=self.sanitize, where="engine",
            registry=self.registry,
        )
        return llrs, llrs.shape[0], False, llrs.shape[0]

    def _cell_length(self, req_code, serial: bool, exact: bool,
                     l_input: int) -> int:
        """Length rung of the cell: exact-length for tail-biting and
        flushed frames, whole puncture periods for serial streams, else
        the ladder."""
        if exact:
            return l_input
        mult = req_code.puncture.n_kept if serial else 1
        return pick_cell_length(l_input, self.min_cell, mult)

    def submit(self, req: DecodeRequest, now: Optional[float] = None
               ) -> Ticket:
        """Enqueue one request; returns its Ticket (``dropped=True`` under
        backpressure).  ``now`` is the submission time (None: the wall
        clock, ``time.monotonic``)."""
        from repro_torch.codes.registry import get_code

        now = time.monotonic() if now is None else now
        try:
            llrs, n_stages, serial, l_input = self._validate(req)
        except InvalidInputError as e:
            # a malformed payload fails its own ticket only; shape misuse
            # still raises (a caller bug)
            ticket = Ticket(
                id=next(self._ids),
                code=req.code,
                slo=req.slo,
                submitted=now,
                n_out=0,
            )
            ticket.done = True
            ticket.error = f"invalid_input:{e.reason}"
            ticket.completed = now
            self._m_requests.inc(1, event="invalid", slo=req.slo)
            return ticket
        code = get_code(req.code)
        tb = code.termination == "tailbiting"
        dec = self._decoder(req.code)
        # a final pin needs a zero-terminated code and a frame that ends
        # on a radix step
        flushed = (
            req.flushed and not tb and n_stages % dec.rho == 0
        )
        l_cell = self._cell_length(code, serial, tb or flushed, l_input)
        ticket = Ticket(
            id=next(self._ids),
            code=req.code,
            slo=req.slo,
            submitted=now,
            n_out=n_stages,
            deadline=req.deadline,
        )
        if req.deadline is not None and now > req.deadline:
            ticket.done = True
            ticket.error = "deadline_exceeded"
            ticket.completed = now
            self._m_requests.inc(1, event="expired", slo=req.slo)
            return ticket
        if self.queue_depth() >= self.max_pending:
            ticket.dropped = True
            self._m_requests.inc(1, event="rejected", slo=req.slo)
            return ticket
        key = (
            req.code, req.slo, l_cell,
            "tb" if tb else ("flushed" if flushed else "open"),
        )
        self._queues.setdefault(key, collections.deque()).append(
            (ticket, llrs)
        )
        self._m_requests.inc(1, event="submitted", slo=req.slo)
        self.recorder.event(
            "engine.enqueue", ticket=ticket.id, code=req.code,
            slo=req.slo, t_cell=l_cell, n_stages=n_stages, now=now,
        )
        return ticket

    def queue_depth(self) -> int:
        """Requests + session chunks waiting (the backpressure signal)."""
        return sum(len(q) for q in self._queues.values()) + sum(
            len(s.pending) for s in self._sessions.values()
        )

    # -- batch assembly + decode ------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[Ticket]:
        """Decode every cell due at ``now`` (full, or its oldest request
        past the SLO's max wait) and all pending session chunks.  Returns
        the tickets completed by this call, plus those completed out of
        band (close_session, eviction) since the last call."""
        now = time.monotonic() if now is None else now
        self._check_hosts(now)
        done, self._done_buffer = self._done_buffer, []
        for key in sorted(self._queues):
            q = self._queues[key]
            while q and (
                len(q) >= self.max_batch
                or now - q[0][0].submitted >= self.max_wait[key[1]]
            ):
                done.extend(self._run_batch(key, q, now))
        done.extend(self._run_sessions(now))
        self._maybe_checkpoint(now)
        return done

    def drain(self, now: Optional[float] = None) -> List[Ticket]:
        """Decode everything queued, partial cells included, and every
        pending session chunk.  Sessions stay open."""
        now = time.monotonic() if now is None else now
        self._check_hosts(now)
        done, self._done_buffer = self._done_buffer, []
        for key in sorted(self._queues):
            q = self._queues[key]
            while q:
                done.extend(self._run_batch(key, q, now))
        done.extend(self._run_sessions(now))
        self._maybe_checkpoint(now)
        return done

    def _run_batch(self, key, q, now: float) -> List[Ticket]:
        code_name, slo, l_cell, kind = key
        rec = self.recorder
        with rec.span(
            "engine.batch", code=code_name, slo=slo, t=l_cell, kind=kind,
            now=now,
        ) as bsp:
            k = min(len(q), self.max_batch)
            entries, shed = [], []
            for _ in range(k):
                ticket, llrs = q.popleft()
                if ticket.deadline is not None and now > ticket.deadline:
                    # expired while queued: a typed error, never late bits
                    ticket.done = True
                    ticket.error = "deadline_exceeded"
                    ticket.completed = now
                    self._m_requests.inc(1, event="expired", slo=slo)
                    shed.append(ticket)
                else:
                    entries.append((ticket, llrs))
            if not entries:
                bsp.set(n_real=0, shed=len(shed))
                return shed
            k = len(entries)
            f_cell = pick_cell_frames(k, self.max_batch)
            dec = self._decoder(code_name)
            serial = dec.puncture is not None
            with rec.span("engine.assemble", n_real=k, f=f_cell):
                shape = (f_cell, l_cell) if serial else (
                    f_cell, l_cell, dec.spec.beta
                )
                dense = np.zeros(shape, np.float32)
                real_elems = 0
                for i, (_, llrs) in enumerate(entries):
                    dense[i, : llrs.shape[0]] = llrs
                    real_elems += llrs.size
                arr = torch.from_numpy(dense).to(dec.device)
            n_stages = (
                dec.puncture.stages_for(l_cell) if serial else l_cell
            )
            path = self._pick_path(code_name, slo, f_cell, n_stages)
            bsp.set(path=path, f=f_cell, n_real=k)
            with rec.span("engine.jit_lookup", path=path):
                fn = self._decode_fn(
                    code_name, path, f_cell, l_cell,
                    flushed=(kind == "flushed"),
                )
            with rec.span(
                "engine.dispatch", code=code_name, path=path,
                f=f_cell, t=l_cell,
            ) as dsp:
                prof = None
                if rec.enabled:
                    prof = dispatch_profile(dec, path, f_cell, n_stages)
                    dsp.set(**prof.span_attrs())
                try:
                    path, out, retries = self._dispatch_with_faults(
                        code_name, fn, path, f_cell, l_cell,
                        kind == "flushed", arr, now, dsp,
                    )
                except KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 — ladder exhausted:
                    # the riders get typed errors, the engine lives on
                    return shed + self._fail_tickets(
                        [t for t, _ in entries], e, slo, now
                    )
                with rec.span("engine.device_wait"):
                    bits = out.cpu().numpy()
                if self.chaos is not None and path != "soft":
                    # armed bit_flip events corrupt the decoded bits after
                    # the dispatch: silent, only the scrubber can see it
                    bits, sdc_device = self.chaos.corrupt(bits)
                else:
                    sdc_device = None
                if prof is not None:
                    wall = rec.clock() - dsp.t0
                    dsp.set(**prof.achieved(wall))
                    self._m_dispatch.observe(
                        wall, code=code_name, path=path, f=f_cell, t=l_cell
                    )
            corrupt_ids: set = set()
            # soft output is real-valued: no rung decodes the same values,
            # so the scrubber has nothing to vote against
            if path != "soft" and self.scrub.enabled and self.scrub.sample():
                with rec.span("engine.scrub", n=k, path=path):
                    corrupt_ids = self._scrub_dispatch(
                        code_name, path, f_cell, l_cell,
                        kind == "flushed", entries, bits, dense,
                        sdc_device, now,
                    )
            with rec.span("engine.emit", n=k):
                for i, (ticket, _) in enumerate(entries):
                    if i in corrupt_ids:
                        ticket.error = "sdc_detected"
                    elif path == "soft":
                        ticket.llrs = (
                            bits[i, : ticket.n_out].astype(np.float32)
                        )
                        ticket.bits = (ticket.llrs < 0).astype(np.int32)
                    else:
                        ticket.bits = (
                            bits[i, : ticket.n_out].astype(np.int32)
                        )
                    ticket.done = True
                    ticket.completed = now
                    ticket.cell = (code_name, slo, l_cell, f_cell)
                    ticket.path = path
                    ticket.retries = retries
                    self._m_sojourn.observe(now - ticket.submitted, slo=slo)
        cl = dict(code=code_name, path=path, f=f_cell, t=l_cell)
        self._m_requests.inc(k - len(corrupt_ids), event="completed", slo=slo)
        if corrupt_ids:
            self._m_requests.inc(len(corrupt_ids), event="sdc", slo=slo)
        self._m_batches.inc(1, slo=slo, **cl)
        self._m_frames.inc(k, kind="real", **cl)
        self._m_frames.inc(f_cell - k, kind="pad", **cl)
        cell_elems = int(np.prod(shape))
        self._m_elems.inc(real_elems, kind="real")
        self._m_elems.inc(cell_elems - real_elems, kind="pad")
        self.batch_log.append(
            dict(
                cell=(code_name, slo, l_cell),
                f_cell=f_cell,
                n_real=k,
                path=path,
                tickets=[t.id for t, _ in entries],
                wait=now - entries[0][0].submitted,
            )
        )
        return shed + [t for t, _ in entries]

    # -- fault handling ----------------------------------------------------

    def _inject(self, code: str, path: str):
        """Chaos hook before every dispatch attempt: raises the injected
        fault, or promotes a straggler delay at or past
        ``dispatch_timeout`` into a ``DispatchTimeout``."""
        if self.chaos is None:
            return
        delay = self.chaos.on_dispatch(code, path)
        if delay:
            self._m_faults.inc(1, kind="slow", path=path)
            if (
                self.dispatch_timeout is not None
                and delay >= self.dispatch_timeout
            ):
                raise DispatchTimeout(
                    f"straggler delay {delay:.3f}s >= dispatch_timeout "
                    f"{self.dispatch_timeout:.3f}s"
                )

    def _ladder(self, path: str) -> tuple:
        """``path``'s rungs in ``DEGRADATION_LADDER``; on the card without
        ``PLAIN_RUNGS``, whose plain versions would hide a kernel."""
        ladder = DEGRADATION_LADDER.get(path, (path,))
        if self.device.type == "cuda":
            ladder = tuple(p for p in ladder if p not in PLAIN_RUNGS)
        return ladder

    def _dispatch_with_faults(
        self, code: str, fn, path: str, f_cell: int, l_cell: int,
        flushed: bool, arr, now: float, dsp,
    ):
        """Run one assembled cell through retries and the degradation
        ladder; returns ``(final_path, out, retries)`` or re-raises once
        every rung has spent its retry budget.  Decode is pure and the
        rungs are bit-identical, so a retried or degraded dispatch emits
        the bits the first attempt would have.  A ``KernelError`` is
        re-raised at once."""
        ladder = self._ladder(path)
        rung, attempt, retries = 0, 0, 0
        while True:
            try:
                self._inject(code, path)
                return path, fn(arr), retries
            except KernelError:
                raise
            except Exception as e:  # noqa: BLE001 — classify below
                kind = getattr(e, "kind", "error")
                if kind != "slow":  # slow already counted by _inject
                    self._m_faults.inc(1, kind=kind, path=path)
                self.recorder.event(
                    "engine.fault", kind=kind, path=path, error=str(e),
                    now=now,
                )
                if dsp is not None:
                    dsp.set(fault=kind)
                degrade_now = False
                if isinstance(e, DeviceFailure):
                    alive = self._handle_device_failure(e.device, now)
                    if path == "sharded":
                        from repro_torch.distributed.decoder import (
                            engine_dispatch_ready,
                        )

                        # retry on the survivors only if the cell still
                        # fills them; otherwise fall to batch
                        degrade_now = not (
                            alive
                            and engine_dispatch_ready(f_cell, self.mesh)
                        )
                if not degrade_now and attempt < self.retry.max_retries:
                    self._m_retries.inc(1, path=path)
                    self._m_backoff.inc(
                        self.retry.backoff(attempt), path=path
                    )
                    attempt += 1
                    retries += 1
                    continue
                if rung + 1 < len(ladder):
                    nxt = ladder[rung + 1]
                    self._m_degraded.inc(1, **{"from": path, "to": nxt})
                    self.recorder.event(
                        "engine.degrade", now=now,
                        **{"from": path, "to": nxt},
                    )
                    rung += 1
                    attempt = 0
                    path = nxt
                    fn = self._decode_fn(
                        code, path, f_cell, l_cell, flushed=flushed
                    )
                    continue
                e.engine_retries = retries  # rides to _fail_tickets
                raise

    # -- online SDC scrubbing ----------------------------------------------

    def _scrub_dispatch(
        self, code_name: str, path: str, f_cell: int, l_cell: int,
        flushed: bool, entries, bits: np.ndarray, dense: np.ndarray,
        sdc_device, now: float,
    ) -> set:
        """Scrub one sampled batch dispatch; returns the entry indices
        confirmed corrupt.  Stage 1 syndrome-checks every real frame
        against its own submitted LLRs; stage 2 re-decodes the whole cell
        once on the shadow rung (off the chaos and retry path) and
        compares bit for bit.  Confirmed corruption quarantines the
        attributed device through ``replan_mesh``."""
        from repro_torch.codes.registry import get_code

        code = get_code(code_name)
        flagged = []
        for i, (ticket, llrs) in enumerate(entries):
            v = self.scrub.check_frame(bits[i, : ticket.n_out], llrs, code)
            self._m_scrub.inc(1, event="frames")
            if v.flagged:
                flagged.append(i)
                self._m_scrub.inc(1, event="syndrome_flag")
        self._m_scrub.inc(1, event="sampled")
        if not flagged or not self.scrub.shadow:
            return set()
        shadow_path = self.scrub.shadow_path(path)
        self.scrub.counts["shadow_dispatches"] += 1
        self._m_scrub.inc(1, event="shadow", path=shadow_path)
        try:
            fn = self._decode_fn(
                code_name, shadow_path, f_cell, l_cell, flushed=flushed
            )
            arr = torch.from_numpy(dense).to(self.device)
            shadow_bits = fn(arr).cpu().numpy()
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — shadow rung unavailable
            # cannot confirm: demote to false alarms rather than fail
            # tickets on unconfirmed suspicion
            self.recorder.event(
                "engine.scrub_shadow_failed", error=repr(e), now=now
            )
            self.scrub.counts["false_alarms"] += len(flagged)
            self._m_scrub.inc(len(flagged), event="false_alarm")
            return set()
        confirmed = set()
        for i in flagged:
            n_out = entries[i][0].n_out
            if np.array_equal(bits[i, :n_out], shadow_bits[i, :n_out]):
                self.scrub.counts["false_alarms"] += 1
                self._m_scrub.inc(1, event="false_alarm")
            else:
                confirmed.add(i)
                self.scrub.counts["confirmed"] += 1
                self._m_scrub.inc(1, event="confirmed")
        if confirmed:
            self.recorder.event(
                "engine.sdc_confirmed", n=len(confirmed), code=code_name,
                path=path, device=sdc_device, now=now,
            )
            if sdc_device is not None and sdc_device not in self._quarantined:
                self._quarantined.add(int(sdc_device))
                self.quarantine_log.append(QuarantineRecord(
                    device=int(sdc_device), at=now, code=code_name,
                    path=path, frames_confirmed=len(confirmed),
                ))
                self._m_quarantine.inc(1)
                self._handle_device_failure(sdc_device, now)
        return confirmed

    def _fail_tickets(self, tickets, exc, slo: str, now: float):
        """Retry budget and ladder exhausted: every rider gets a typed
        error; the engine keeps serving."""
        err = f"decode_failed:{type(exc).__name__}"
        for t in tickets:
            t.done = True
            t.error = err
            t.retries = getattr(exc, "engine_retries", 0)
            t.completed = now
        self._m_requests.inc(len(tickets), event="failed", slo=slo)
        self.recorder.event(
            "engine.batch_failed", n=len(tickets), error=repr(exc), now=now
        )
        return tickets

    def _handle_device_failure(self, device, now: float) -> bool:
        """Remove a failed device and re-plan the mesh onto the survivors
        (``replan_mesh``).  True when a mesh survives.  Cached sharded
        callables late-bind ``self.mesh``."""
        if device is not None:
            self._failed_devices.add(int(device))
        self._m_failover.inc(1)
        n_dev = 0
        if self.mesh is not None:
            from repro_torch.distributed.decoder import replan_mesh

            self.mesh = replan_mesh(self.mesh, self._failed_devices)
            n_dev = 0 if self.mesh is None else self.mesh.size
        self.recorder.event(
            "engine.failover", device=device, devices=n_dev, now=now
        )
        return self.mesh is not None

    def _check_hosts(self, now: float):
        """Hosts the ``HeartbeatMonitor`` declares failed leave the mesh
        like an in-dispatch ``DeviceFailure``."""
        if self.monitor is None:
            return
        for h in self.monitor.failed(now):
            if h not in self._failed_devices:
                self._handle_device_failure(h, now)

    # -- sessions ----------------------------------------------------------

    def open_session(
        self,
        code: str = "ccsds-k7",
        sid: Optional[str] = None,
        now: Optional[float] = None,
    ) -> str:
        """Register a chunked-streaming tenant; returns its session id.
        Overflowing ``session_capacity`` evicts the least recently used
        session first."""
        now = time.monotonic() if now is None else now
        dec = self._decoder(code)  # validates the code name
        sid = sid if sid is not None else f"s{next(self._sids)}"
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} already open")
        while len(self._sessions) >= self.session_capacity:
            self._evict_lru(now)
        self._sessions[sid] = _Session(
            sid=sid,
            code=code,
            state=dec.init_stream_state(1, initial_state=None),
            pending=collections.deque(),
            last_used=now,
        )
        self._m_sessions.inc(1, event="opened")
        self._m_open_sessions.set(len(self._sessions))
        return sid

    def _shape_chunk(self, dec: ViterbiDecoder, llrs) -> torch.Tensor:
        """One session chunk -> (1, c, beta) stages on the decoder's
        device.  Punctured sessions submit serial chunks of whole pattern
        periods (so chunk-wise depuncturing equals whole-stream
        depuncturing); stage counts must sit on the rho grid."""
        llrs = np.asarray(llrs, np.float32)
        if dec.puncture is not None:
            if llrs.ndim != 1:
                raise ValueError(
                    "punctured sessions take serial (Lp,) chunks, got "
                    f"shape {llrs.shape}"
                )
            kept = dec.puncture.n_kept
            if llrs.shape[0] % kept:
                raise ValueError(
                    f"serial session chunks must be whole puncture "
                    f"periods ({kept} kept LLRs); got {llrs.shape[0]}"
                )
            shaped = dec.depunctured(llrs[None])
        else:
            if llrs.ndim != 2 or llrs.shape[1] != dec.spec.beta:
                raise ValueError(
                    f"session chunks are (c, beta={dec.spec.beta}) "
                    f"stages, got shape {llrs.shape}"
                )
            shaped = torch.from_numpy(llrs[None]).to(dec.device)
        if shaped.shape[1] % dec.rho:
            raise ValueError(
                f"chunk stage count {shaped.shape[1]} not divisible by "
                f"rho={dec.rho}"
            )
        return shaped

    def submit_chunk(
        self, sid: str, llrs, now: Optional[float] = None
    ) -> Ticket:
        """Queue one LLR chunk on a session; the ticket completes (with
        the bits that became final) at the next poll or drain."""
        now = time.monotonic() if now is None else now
        sess = self._sessions[sid]
        shaped = self._shape_chunk(self._decoder(sess.code), llrs)
        ticket = Ticket(
            id=next(self._ids),
            code=sess.code,
            slo="throughput",
            submitted=now,
            n_out=-1,  # emission depends on stream position
        )
        if self.queue_depth() >= self.max_pending:
            ticket.dropped = True
            self._m_requests.inc(1, event="rejected", slo="throughput")
            return ticket
        sess.pending.append((ticket, shaped))
        self._sessions.move_to_end(sid)
        sess.last_used = now
        self._m_requests.inc(1, event="submitted", slo="throughput")
        return ticket

    def _run_sessions(self, now: float) -> List[Ticket]:
        """Drain pending session chunks, one chunk per session per round,
        rounds grouped by (code, chunk stages) into ``decode_chunk_multi``
        dispatches of at most ``max_batch`` sessions.  A group whose
        dispatch fails for good has its head chunks requeued and its
        sessions stalled for the rest of this poll."""
        done: List[Ticket] = []
        stalled: set = set()
        while True:
            groups: Dict[Tuple, List[_Session]] = {}
            for sid in sorted(self._sessions):
                sess = self._sessions[sid]
                if sess.pending and sid not in stalled:
                    key = (sess.code, sess.pending[0][1].shape[1])
                    groups.setdefault(key, []).append(sess)
            if not groups:
                return done
            for (code_name, c), sessions in sorted(groups.items()):
                for lo in range(0, len(sessions), self.max_batch):
                    batch = sessions[lo: lo + self.max_batch]
                    out, ok = self._dispatch_session_group(
                        code_name, c, batch, now,
                    )
                    done.extend(out)
                    if not ok:
                        stalled.update(s.sid for s in batch)

    def _dispatch_session_group(
        self, code_name: str, c: int, sessions: List[_Session], now: float,
        abandon_on_failure: bool = False,
    ) -> Tuple[List[Ticket], bool]:
        """One fused dispatch of <= max_batch sessions' head chunks.
        Returns ``(completed tickets, ok)``.  ``decode_chunk_multi`` is
        functional (states are reassigned only after it returns), so a
        retry runs on untouched carries.  On a failure for good the head
        chunks are requeued, or on the close/eviction path
        (``abandon_on_failure``) their tickets get typed errors.  A
        ``KernelError`` is re-raised at once."""
        dec = self._decoder(code_name)
        rec = self.recorder
        with rec.span(
            "engine.batch", code=code_name, slo="throughput", t=c,
            kind="session", path="session", now=now,
        ):
            tickets, chunks, states = [], [], []
            k = len(sessions)
            f_cell = pick_cell_frames(k, self.max_batch)
            with rec.span("engine.assemble", n_real=k, f=f_cell):
                for sess in sessions:
                    ticket, shaped = sess.pending.popleft()
                    tickets.append(ticket)
                    chunks.append(shaped)
                    states.append(sess.state)
                if f_cell > k:  # pad with throwaway zero states
                    states.append(dec.init_stream_state(f_cell - k))
                    chunks.append(torch.zeros(
                        (f_cell - k, c, dec.spec.beta), dtype=torch.float32,
                        device=dec.device,
                    ))
            key = (code_name, "session", f_cell, c)
            with rec.span("engine.jit_lookup", path="session"):
                if key in self._fns:
                    self._m_jit.inc(1, event="hit")
                else:
                    self._m_jit.inc(1, event="miss")
                    self._fns[key] = dec.decode_chunk_multi
                    self._m_jit_entries.set(len(self._fns))
            with rec.span(
                "engine.dispatch", code=code_name, path="session",
                f=f_cell, t=c,
            ) as dsp:
                prof = None
                if rec.enabled:
                    prof = dispatch_profile(dec, "session", f_cell, c)
                    dsp.set(**prof.span_attrs())
                attempt = retries = 0
                while True:
                    try:
                        self._inject(code_name, "session")
                        new_states, outs = self._fns[key](states, chunks)
                        break
                    except KernelError:
                        raise
                    except Exception as e:  # noqa: BLE001 — the guard
                        kind = getattr(e, "kind", "error")
                        if kind != "slow":
                            self._m_faults.inc(1, kind=kind, path="session")
                        self.recorder.event(
                            "engine.fault", kind=kind, path="session",
                            error=str(e), now=now,
                        )
                        dsp.set(fault=kind)
                        if isinstance(e, DeviceFailure):
                            self._handle_device_failure(e.device, now)
                        if attempt < self.retry.max_retries:
                            self._m_retries.inc(1, path="session")
                            self._m_backoff.inc(
                                self.retry.backoff(attempt), path="session"
                            )
                            attempt += 1
                            retries += 1
                            continue
                        # for good: the states are untouched; defer or
                        # abandon, never corrupt
                        e.engine_retries = retries
                        return self._session_dispatch_failed(
                            sessions, tickets, chunks, e, now,
                            abandon_on_failure,
                        ), False
                with rec.span("engine.device_wait"):
                    outs = [o.cpu().numpy() for o in outs]
                if self.chaos is not None and outs:
                    # fire any armed bit_flip here, so corruption never
                    # leaks onto a later dispatch; sessions are not
                    # scrubbed
                    outs[0], _ = self.chaos.corrupt(outs[0])
                if prof is not None:
                    wall = rec.clock() - dsp.t0
                    dsp.set(**prof.achieved(wall))
                    self._m_dispatch.observe(
                        wall, code=code_name, path="session", f=f_cell, t=c
                    )
            done: List[Ticket] = []
            with rec.span("engine.emit", n=k):
                for sess, ticket, state, out in zip(
                    sessions, tickets, new_states, outs
                ):
                    sess.state = state
                    sess.consumed_steps += c
                    ticket.bits = np.asarray(out[0]).astype(np.int32)
                    ticket.n_out = ticket.bits.shape[0]
                    ticket.done = True
                    ticket.completed = now
                    ticket.path = "session"
                    ticket.retries = retries
                    done.append(ticket)
                    self._m_sojourn.observe(
                        now - ticket.submitted, slo="throughput"
                    )
        cl = dict(code=code_name, path="session", f=f_cell, t=c)
        self._m_requests.inc(k, event="completed", slo="throughput")
        self._m_batches.inc(1, slo="throughput", **cl)
        self._m_frames.inc(k, kind="real", **cl)
        self._m_frames.inc(f_cell - k, kind="pad", **cl)
        self._m_elems.inc(k * c * dec.spec.beta, kind="real")
        self._m_elems.inc((f_cell - k) * c * dec.spec.beta, kind="pad")
        self.batch_log.append(
            dict(
                cell=(code_name, "session", c),
                f_cell=f_cell,
                n_real=k,
                path="session",
                tickets=[t.id for t in tickets],
                wait=0.0,
            )
        )
        return done, True

    def _session_dispatch_failed(
        self, sessions, tickets, chunks, exc, now: float,
        abandon: bool,
    ) -> List[Ticket]:
        """A session group failed for good: requeue the popped head
        chunks (they retry at the next poll), or on the close/eviction
        path fail their tickets with typed errors."""
        if abandon:
            return self._fail_tickets(tickets, exc, "throughput", now)
        for sess, ticket, shaped in zip(sessions, tickets, chunks):
            sess.pending.appendleft((ticket, shaped))
        self.recorder.event(
            "engine.session_deferred", n=len(tickets), error=repr(exc),
            now=now,
        )
        return []

    def close_session(
        self, sid: str, now: Optional[float] = None
    ) -> np.ndarray:
        """Finish a session: decode its pending chunks (this session
        only), flush the survivor ring and remove it.  Returns the tail
        bits.  Chunk tickets completed here are delivered by the next
        poll or drain."""
        now = time.monotonic() if now is None else now
        sess = self._sessions[sid]
        while sess.pending:  # decode in order, this session only
            out, _ok = self._dispatch_session_group(
                sess.code, sess.pending[0][1].shape[1], [sess], now,
                abandon_on_failure=True,  # a close cannot defer
            )
            self._done_buffer.extend(out)
        dec = self._decoder(sess.code)
        tail = dec.flush_stream(sess.state)[0].cpu().numpy().astype(np.int32)
        del self._sessions[sid]
        self._m_sessions.inc(1, event="closed")
        self._m_open_sessions.set(len(self._sessions))
        return tail

    def _evict_lru(self, now: float):
        """Session-table overflow: close the least recently used session
        (a forced close loses no bits) and park its tail for
        ``evicted_tail``."""
        sid = next(iter(self._sessions))
        self._evicted[sid] = self.close_session(sid, now)
        while len(self._evicted) > 64:  # bounded: unread tails expire
            self._evicted.popitem(last=False)
        self._m_sessions.inc(1, event="evicted")

    def evicted_tail(self, sid: str) -> np.ndarray:
        """Tail bits of an evicted session (kept until read once)."""
        return self._evicted.pop(sid)

    # -- session durability ------------------------------------------------

    def checkpoint_sessions(self, now: Optional[float] = None):
        """Write the session table to ``checkpoint_dir``
        (``runtime.checkpoint.save_sessions``, manifest last): each
        session's whole ``StreamState``, copied to the host, so a restore
        resumes the exact carry.  Returns the step's path, or None when
        checkpointing is off."""
        if self.checkpoint_dir is None:
            return None
        now = time.monotonic() if now is None else now
        from repro_torch.runtime import checkpoint as ckpt

        records = {
            sid: {
                "lam": s.state.lam.cpu().numpy(),
                "hist": s.state.hist.cpu().numpy(),
                "pos": int(s.state.pos),
                "code": s.code,
                "consumed": int(s.consumed_steps),
            }
            for sid, s in self._sessions.items()
        }
        step = next(self._ckpt_steps)
        path = ckpt.save_sessions(
            self.checkpoint_dir, step, records, extra={"now": now}
        )
        self._last_ckpt = now
        self._m_ckpt.inc(1)
        self.recorder.event(
            "engine.checkpoint", step=step, sessions=len(records), now=now
        )
        return path

    def _maybe_checkpoint(self, now: float):
        """Periodic session-table checkpoint on the engine clock."""
        if self.checkpoint_dir is None or self.checkpoint_interval is None:
            return
        if (
            self._last_ckpt is None
            or now - self._last_ckpt >= self.checkpoint_interval
        ):
            self.checkpoint_sessions(now)

    def restore_sessions(
        self, ckpt_dir=None, now: Optional[float] = None
    ) -> Dict[str, int]:
        """Rebuild the session table from the latest complete checkpoint
        in ``ckpt_dir`` (default: ``checkpoint_dir``), written by this
        package's engine or the reference's, its arrays moved to the
        decoder's device.  Returns ``{sid: consumed stages}``, where each
        client resumes its feed."""
        from repro_torch.core.decoder import StreamState
        from repro_torch.runtime import checkpoint as ckpt

        now = time.monotonic() if now is None else now
        step, records, _extra = ckpt.load_sessions(
            ckpt_dir if ckpt_dir is not None else self.checkpoint_dir
        )
        resume: Dict[str, int] = {}
        for sid, recd in records.items():
            if sid in self._sessions:
                raise ValueError(f"session {sid!r} already open")
            dec = self._decoder(recd["code"])  # validates the code name
            self._sessions[sid] = _Session(
                sid=sid,
                code=recd["code"],
                state=StreamState(
                    lam=torch.from_numpy(recd["lam"]).to(dec.device),
                    hist=torch.from_numpy(recd["hist"]).to(dec.device),
                    pos=int(recd["pos"]),
                ),
                pending=collections.deque(),
                last_used=now,
                consumed_steps=int(recd["consumed"]),
            )
            self._m_sessions.inc(1, event="restored")
            resume[sid] = int(recd["consumed"])
        self._m_open_sessions.set(len(self._sessions))
        if records:
            self.recorder.event(
                "engine.restore", step=step, sessions=len(records), now=now
            )
        return resume

    # -- convenience / stats ----------------------------------------------

    def decode(
        self, requests: List[DecodeRequest], now: float = 0.0
    ) -> List[np.ndarray]:
        """Submit and drain in one call; bits per request, in order."""
        tickets = [self.submit(r, now=now) for r in requests]
        self.drain(now=now)
        if any(t.dropped for t in tickets):
            raise RuntimeError("backpressure drop inside decode()")
        errs = sorted({t.error for t in tickets if t.error})
        if errs:
            raise RuntimeError(f"typed errors inside decode(): {errs}")
        return [t.bits for t in tickets]

    def stats(self) -> dict:
        """Operator counters, read back from ``self.registry``: the
        reference's keys and numbers."""
        real_frames = self._m_frames.total(kind="real")
        cell_frames = real_frames + self._m_frames.total(kind="pad")
        real_elems = self._m_elems.total(kind="real")
        cell_elems = real_elems + self._m_elems.total(kind="pad")
        lat = {}
        for slo in SLO_CLASSES:
            n = self._m_sojourn.count(slo=slo)
            if n:
                lat[slo] = {
                    "n": int(min(n, 4096)),  # the exact-window bound
                    "p50": float(self._m_sojourn.quantile(0.50, slo=slo)),
                    "p99": float(self._m_sojourn.quantile(0.99, slo=slo)),
                }
        paths: Dict[str, int] = {}
        for lbl, v in self._m_batches.series():
            p = lbl.get("path", "?")
            paths[p] = paths.get(p, 0) + int(v)
        faults: Dict[str, int] = {}
        for lbl, v in self._m_faults.series():
            kd = lbl.get("kind", "?")
            faults[kd] = faults.get(kd, 0) + int(v)
        qd = self.queue_depth()
        self._m_queue.set(qd)
        self._m_open_sessions.set(len(self._sessions))
        return {
            "submitted": int(self._m_requests.total(event="submitted")),
            "completed": int(self._m_requests.total(event="completed")),
            "rejected": int(self._m_requests.total(event="rejected")),
            "batches": int(self._m_batches.total()),
            "queue_depth": qd,
            "sessions": len(self._sessions),
            "sessions_evicted": int(
                self._m_sessions.value(event="evicted")
            ),
            "paths": paths,
            "occupancy": (
                real_frames / cell_frames if cell_frames else 0.0
            ),
            "padding_waste": (
                1.0 - real_elems / cell_elems if cell_elems else 0.0
            ),
            "jit_cache": {
                "hits": int(self._m_jit.value(event="hit")),
                "misses": int(self._m_jit.value(event="miss")),
                "entries": len(self._fns),
            },
            "latency": lat,
            "faults": faults,
            "retries": int(self._m_retries.total()),
            "degraded": int(self._m_degraded.total()),
            "failovers": int(self._m_failover.total()),
            "expired": int(self._m_requests.total(event="expired")),
            "failed": int(self._m_requests.total(event="failed")),
            "checkpoints": int(self._m_ckpt.total()),
            "scrub": self.scrub.stats(),
            "quarantined": sorted(self._quarantined),
            "invalid": int(self._m_requests.total(event="invalid")),
            "sanitized": int(self._m_sanitized.total()),
        }
