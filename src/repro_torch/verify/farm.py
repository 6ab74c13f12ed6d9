"""Sharded Monte-Carlo BER farm, the port of the reference's
``verify/farm.py`` (DESIGN.md §11).

``BerFarm`` runs a (registry code x Eb/N0 x decode path) grid.  Every
grid point draws its frames from the per-batch seed schedule of
``codes.simulate.batch_keys``: batch ``b`` of a point is one
``torch.Generator`` seed whichever shard draws it and whichever decode
path consumes it, so a sharded farm's error counts equal the
single-device counts exactly (integer sums of identical per-batch
counts), and path-against-reference comparisons (``verify.gate``) are at
matched noise.  The seeds are not the reference's ``jax.random`` keys,
and a CPU generator draws other numbers than a CUDA one: the port's
counts are held to the reference's by the gate's interval overlap, not
number for number.

Execution: every path is a host loop over the point's batch seeds
(draw on the device -> encode -> AWGN -> decode -> count), the counts
summed on the device and read once a chunk of ``scan_chunk`` batches.
Where the reference scans its "jit paths" (``reference``,
``time_parallel``) under ``shard_map`` with the key axis split over a
mesh, the port splits each chunk's seeds into contiguous blocks over the
shards of a ``distributed.decoder.FrameMesh`` (cards, or logical shards
of one device): each shard draws and decodes its batches on its own
device.  The host paths (``kernel``, ``engine``, ``sharded``) iterate
every seed on the farm's device, as in the reference.

Decode paths (``decode_fn``), each the reference's on the port's entry
points:
  * ``reference``: ``decode_batch(time_parallel=False)``, K1 and the
    traceback;
  * ``kernel``: ``decode_stream_chunked`` at a decision depth of
    ``KERNEL_DECISION_DEPTH`` stages, K2 where the one-pass rule admits
    the chunk and K1 where it refuses;
  * ``time_parallel``: ``decode_batch(time_parallel=True)``, K3 and K1;
  * ``engine``: a ``serve.engine.DecodeEngine`` with ``flushed=`` frames;
  * ``sharded``: ``decode_sharded`` over every card (one CPU shard off
    the card);
  * tail-biting codes decode through ``decode_tailbiting`` (WAVA) on
    every path but ``sharded``, which refuses them.

Every path but ``time_parallel`` (and the engine, which keeps its own
routing) passes ``time_parallel=False``: the reference's baseline is the
sequential decode, and the card's auto-selection budget
(``backend.CUDA_ROW_BUDGET``) would otherwise move small tail-biting
batches onto the time-parallel WAVA, where the reference's auto
selection on its CPU never goes.

Totals are Python ints, so a million-frame grid cannot overflow.  Each
point reports Wilson and Clopper-Pearson intervals through
``core.ber.estimate_ber``; a zero-error cell reports its one-sided
upper bound, never 0.0.

CLI (exits 1 on any gate failure)::

    PYTHONPATH=src python -m repro_torch.verify.farm              # smoke grid
    PYTHONPATH=src python -m repro_torch.verify.farm --full       # nightly grid
    PYTHONPATH=src python -m repro_torch.verify.farm --device cpu # off the card
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.codes.registry import StandardCode, get_code
from repro_torch.codes.simulate import batch_keys, count_errors, sim_frame_batch
from repro_torch.core.backend import resolve_device
from repro_torch.core.ber import DEFAULT_CONFIDENCE, BerEstimate, estimate_ber
from repro_torch.core.decoder import ViterbiDecoder

__all__ = [
    "PATHS", "KERNEL_DECISION_DEPTH", "FarmPoint", "BerFarm",
    "farm_to_json", "main",
]

# decode paths the farm can measure; "reference" is the gate's baseline
PATHS = ("reference", "kernel", "time_parallel", "engine", "sharded")
# the reference's jit paths: with a mesh, their seeds split over its shards
_MESH_PATHS = frozenset({"reference", "time_parallel"})

# streaming decision depth of the kernel path's decoder (stages): far
# below the 5120-stage serving default, so that the farm would catch a
# depth regression, while >= 70 constraint lengths keeps it clean at any
# operating SNR
KERNEL_DECISION_DEPTH = 512


@dataclasses.dataclass(frozen=True)
class FarmPoint:
    """Aggregated counts of one (code, Eb/N0, path) grid cell."""

    code: str
    path: str
    ebn0_db: float
    n_frames: int
    frame_bits: int  # message bits per frame
    n_bits: int      # total message bits scored ( = n_frames * frame_bits)
    bit_errors: int
    frame_errors: int
    confidence: float = DEFAULT_CONFIDENCE
    seconds: float = dataclasses.field(default=0.0, compare=False)

    def estimate(self, method: str = "clopper-pearson") -> BerEstimate:
        """Confidence-bounded BER of this cell."""
        return estimate_ber(
            self.bit_errors, self.n_bits,
            confidence=self.confidence, method=method,
        )

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.n_frames, 1)


def _message_bits(code: StandardCode, frame_budget: int) -> int:
    """Message bits per frame for a transmit budget of ``frame_budget``
    trellis stages: tail-biting frames spend every stage on message
    bits; zero-terminated codes spend k-1 on the flush tail.  A
    power-of-two budget keeps every code on the same stage count."""
    if frame_budget % 2:
        raise ValueError(f"frame_budget must be even, got {frame_budget}")
    if code.termination == "tailbiting":
        return frame_budget
    n = frame_budget - (code.spec.k - 1)
    if n <= 0:
        raise ValueError(
            f"frame_budget={frame_budget} cannot fit the k-1="
            f"{code.spec.k - 1} tail of {code.name}"
        )
    return n


class BerFarm:
    """The Monte-Carlo farm (module docstring).

    Parameters
    ----------
    codes            : registry code names of the grid.
    ebn0_dbs         : Eb/N0 grid points, dB (calibrated per EFFECTIVE
                       rate, so punctured codes are honest).
    paths            : decode paths to measure (subset of ``PATHS``).
    frames_per_point : frames per grid cell (rounded up to whole
                       batches, and to whole per-shard batch counts
                       when a mesh is given; the actual count is in
                       each FarmPoint).
    frame_budget     : transmit stages per frame (message bits =
                       budget - (k-1) for zero-terminated codes).
    batch_frames     : frames per Monte-Carlo batch.
    mesh             : optional ``distributed.decoder.FrameMesh``: the
                       reference and time_parallel paths split their
                       seeds over its shards.
    scan_chunk       : batches whose counts are read at once; each chunk
                       emits one progress event.
    recorder         : optional ``obs.SpanRecorder``: each grid point
                       runs inside a ``farm.point`` span that emits
                       ``farm.progress`` events per chunk (frames/s,
                       errors so far, Wilson CI width); the no-op
                       ``NullRecorder`` by default.
    device           : the device of the decoders and the draws without
                       a mesh (None is the card).
    """

    def __init__(
        self,
        codes: Sequence[str],
        ebn0_dbs: Sequence[float],
        paths: Sequence[str] = ("reference",),
        frames_per_point: int = 1024,
        frame_budget: int = 256,
        batch_frames: int = 32,
        seed: int = 0,
        confidence: float = DEFAULT_CONFIDENCE,
        mesh=None,
        kernel_decision_depth: int = KERNEL_DECISION_DEPTH,
        scan_chunk: int = 4096,
        recorder=None,
        device=None,
    ):
        from repro_torch.obs.trace import NullRecorder

        self.recorder = recorder if recorder is not None else NullRecorder()
        unknown = [p for p in paths if p not in PATHS]
        if unknown:
            raise ValueError(f"unknown decode paths {unknown}; known {PATHS}")
        self.device = resolve_device(device)
        self.codes = [get_code(c).name for c in codes]  # validate names
        self.ebn0_dbs = [float(e) for e in ebn0_dbs]
        self.paths = tuple(paths)
        self.frame_budget = int(frame_budget)
        self.batch_frames = int(batch_frames)
        self.seed = int(seed)
        self.confidence = float(confidence)
        self.mesh = mesh
        self.kernel_decision_depth = int(kernel_decision_depth)
        n_shards = 1 if mesh is None else mesh.size
        n_batches = -(-int(frames_per_point) // self.batch_frames)
        self.n_batches = -(-n_batches // n_shards) * n_shards
        self.scan_chunk = -(-int(scan_chunk) // n_shards) * n_shards
        self._decoders: Dict[Tuple[str, str, torch.device], ViterbiDecoder] = {}
        self._engine = None

    # -- decode-path factory ----------------------------------------------

    def _decoder(self, code_name: str, path: str,
                 device: torch.device) -> ViterbiDecoder:
        key = (code_name, path, device)
        if key not in self._decoders:
            kw = {}
            if path == "kernel":
                kw = dict(decision_depth=self.kernel_decision_depth)
            elif path == "time_parallel":
                kw = dict(time_parallel=True)
            self._decoders[key] = ViterbiDecoder.from_standard(
                code_name, device=device, **kw
            )
        return self._decoders[key]

    def _engine_obj(self):
        if self._engine is None:
            from repro_torch.serve.engine import DecodeEngine

            self._engine = DecodeEngine(
                max_batch=self.batch_frames, device=self.device
            )
        return self._engine

    def decode_fn(self, code_name: str, path: str, device=None):
        """(F, n, beta) | serial (F, Lp) llrs -> (F, >= message bits)
        decoded bits, on the named path, decoding on ``device`` (default
        the farm's).  Zero-terminated paths pin both trellis ends (the tx
        chain flushed to state 0); the engine path keeps its own contract
        (flushed frames pinned at both ends)."""
        code = get_code(code_name)
        tailbiting = code.termination == "tailbiting"
        device = self.device if device is None else resolve_device(device)
        if path == "engine":
            from repro_torch.serve.engine import DecodeRequest

            engine = self._engine_obj()

            def engine_fn(llrs):
                arr = torch.as_tensor(llrs).cpu().numpy()
                # farm frames carry their zero tail (sim_frame_batch ->
                # tx_frames), so they declare the flushed framing
                reqs = [
                    DecodeRequest(
                        llrs=arr[i], code=code_name,
                        flushed=not tailbiting,
                    )
                    for i in range(arr.shape[0])
                ]
                return torch.from_numpy(np.stack(engine.decode(reqs)))

            return engine_fn
        dec = self._decoder(code_name, path, device)
        if tailbiting:
            if path == "sharded":
                raise ValueError(
                    f"{code_name}: sharded tail-biting decode is not "
                    "implemented (DESIGN.md §6); drop 'sharded' from "
                    "the farm paths for tail-biting codes"
                )
            tp = path == "time_parallel"
            return lambda llrs: dec.decode_tailbiting(
                llrs, time_parallel=tp
            )[0]
        if path == "kernel":
            return lambda llrs: dec.decode_stream_chunked(
                llrs, initial_state=0, final_state=0
            )
        if path == "sharded":
            return lambda llrs: dec.decode_sharded(
                llrs, initial_state=0, final_state=0
            )
        if path == "time_parallel":
            return lambda llrs: dec.decode_batch(
                llrs, initial_state=0, final_state=0, time_parallel=True
            )
        return lambda llrs: dec.decode_batch(
            llrs, initial_state=0, final_state=0, time_parallel=False
        )

    # -- point runners -----------------------------------------------------

    def _counts(self, decode, code, n_msg, ebn0_db, keys, device):
        """(bit errors, frame errors) over the batches seeded by ``keys``,
        drawn and decoded on ``device``; summed there and read once."""
        be = torch.zeros((), dtype=torch.int64, device=device)
        fe = torch.zeros((), dtype=torch.int64, device=device)
        for key in keys:
            gen = torch.Generator(device=device).manual_seed(int(key))
            bits, llrs = sim_frame_batch(
                gen, code, self.batch_frames, n_msg, ebn0_db, rho=2
            )
            b, f = count_errors(decode(llrs), bits)
            be += b.to(device)
            fe += f.to(device)
        return int(be), int(fe)

    def _counts_chunk(self, decode, code_name, path, code, n_msg, ebn0_db,
                      keys):
        """One chunk of batch seeds: split into contiguous blocks over the
        mesh's shards for the mesh paths, each shard decoding on its own
        device, else all decoded by ``decode`` on the farm's device."""
        if self.mesh is None or path not in _MESH_PATHS:
            return self._counts(decode, code, n_msg, ebn0_db, keys, self.device)
        per = len(keys) // self.mesh.size
        be = fe = 0
        for i, dev in enumerate(self.mesh.devices):
            decode = self.decode_fn(code_name, path, dev)
            b, f = self._counts(decode, code, n_msg, ebn0_db,
                                keys[i * per:(i + 1) * per], dev)
            be += b
            fe += f
        return be, fe

    def run_point(self, code_name: str, ebn0_db: float, path: str
                  ) -> FarmPoint:
        """Measure one grid cell; the unit the grid loop and the tests
        share."""
        code = get_code(code_name)
        n_msg = _message_bits(code, self.frame_budget)
        decode = self.decode_fn(code_name, path)
        keys = batch_keys(self.seed, code_name, ebn0_db, self.n_batches)
        t0 = time.perf_counter()
        be = fe = 0
        with self.recorder.span(
            "farm.point", code=code_name, path=path, ebn0_db=float(ebn0_db),
            n_frames=self.n_batches * self.batch_frames, frame_bits=n_msg,
        ) as sp:
            for lo in range(0, self.n_batches, self.scan_chunk):
                b, f = self._counts_chunk(
                    decode, code_name, path, code, n_msg, ebn0_db,
                    keys[lo: lo + self.scan_chunk],
                )
                be += b
                fe += f
                frames = min(
                    lo + self.scan_chunk, self.n_batches
                ) * self.batch_frames
                elapsed = time.perf_counter() - t0
                est = estimate_ber(
                    be, frames * n_msg,
                    confidence=self.confidence, method="wilson",
                )
                sp.event(
                    "farm.progress",
                    frames=frames,
                    frames_per_s=frames / elapsed if elapsed > 0 else 0.0,
                    bit_errors=be,
                    frame_errors=fe,
                    ber=est.ber,
                    wilson_ci_width=est.ci_hi - est.ci_lo,
                )
            sp.set(bit_errors=be, frame_errors=fe)
        dt = time.perf_counter() - t0
        n_frames = self.n_batches * self.batch_frames
        return FarmPoint(
            code=code_name, path=path, ebn0_db=float(ebn0_db),
            n_frames=n_frames, frame_bits=n_msg,
            n_bits=n_frames * n_msg,
            bit_errors=be, frame_errors=fe,
            confidence=self.confidence, seconds=dt,
        )

    def run(self, progress=None) -> List[FarmPoint]:
        """The full grid, reference path first (so gate pairing always
        finds its baseline).  ``progress`` is an optional callable fed
        each finished FarmPoint (the CLI prints rows live with it)."""
        ordered = sorted(self.paths, key=lambda p: p != "reference")
        points = []
        for path in ordered:
            for code_name in self.codes:
                for ebn0_db in self.ebn0_dbs:
                    p = self.run_point(code_name, ebn0_db, path)
                    if progress is not None:
                        progress(p)
                    points.append(p)
        return points


# ---------------------------------------------------------------------------
# Serialization + CLI
# ---------------------------------------------------------------------------

def farm_to_json(points: Sequence[FarmPoint], verdicts=None) -> dict:
    """Counts, CIs and gate verdicts as one JSON-able object (the
    reference's schema)."""
    rows = []
    for p in points:
        est = p.estimate()
        rows.append(
            {
                "code": p.code, "path": p.path, "ebn0_db": p.ebn0_db,
                "n_frames": p.n_frames, "frame_bits": p.frame_bits,
                "n_bits": p.n_bits, "bit_errors": p.bit_errors,
                "frame_errors": p.frame_errors, "fer": p.fer,
                "ber": est.ber, "ci_lo": est.ci_lo, "ci_hi": est.ci_hi,
                "confidence": est.confidence, "method": est.method,
                "upper_bound": est.upper_bound, "seconds": p.seconds,
            }
        )
    out = {"points": rows}
    if verdicts is not None:
        out["gate"] = [
            {
                "code": v.code, "path": v.path, "ebn0_db": v.ebn0_db,
                "passed": v.passed, "reason": v.reason,
            }
            for v in verdicts
        ]
        out["all_pass"] = all(v.passed for v in verdicts)
    return out


def _point_row(p: FarmPoint) -> str:
    est = p.estimate()
    return (
        f"{p.code}/{p.path}@ebn0={p.ebn0_db:g} "
        f"ber={est.ber:.3e} ci=[{est.ci_lo:.3e},{est.ci_hi:.3e}] "
        f"errors={p.bit_errors}/{p.n_bits}"
        f"{' (upper bound)' if est.upper_bound else ''} "
        f"fer={p.fer:.3e} [{p.seconds:.1f}s]"
    )


def main(argv=None) -> int:
    """The BER-gate CLI: the smoke grid by default, ``--full`` for the
    nightly grid; scale ``--frames`` up for millions-of-frames runs.
    Decodes on the card unless ``--device cpu``."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="nightly grid: all farm codes + engine path")
    ap.add_argument("--codes", default=None,
                    help="comma-separated registry codes (overrides grid)")
    ap.add_argument("--ebn0", default=None,
                    help="comma-separated Eb/N0 points, dB")
    ap.add_argument("--paths", default=None,
                    help=f"comma-separated decode paths from {PATHS}")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per grid point")
    ap.add_argument("--frame-budget", type=int, default=256,
                    help="transmit stages per frame")
    ap.add_argument("--batch-frames", type=int, default=16,
                    help="frames per Monte-Carlo batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--confidence", type=float, default=DEFAULT_CONFIDENCE)
    ap.add_argument("--out", default=None,
                    help="write the JSON trajectory artifact here")
    ap.add_argument(
        "--progress", action="store_true",
        help="emit per-point farm.point spans with farm.progress "
        "events (frames/s, errors so far, Wilson CI width) to the "
        "--trace-out JSONL",
    )
    ap.add_argument(
        "--trace-out", default="experiments/obs/farm.jsonl",
        help="JSONL file the --progress span events append to",
    )
    ap.add_argument("--device", default=None,
                    help="device to decode on (default: the card; 'cpu')")
    args = ap.parse_args(argv)

    if args.full:
        codes = "ccsds-k7,wifi-11a-r34,lte-tbcc,gsm-cs1"
        paths = "reference,kernel,time_parallel,engine"
        frames = 4096
    else:
        codes = "ccsds-k7,wifi-11a-r34"
        paths = "reference,kernel,time_parallel"
        frames = 32
    ebn0 = args.ebn0 or "2,4,6"
    recorder = None
    if args.progress:
        from repro_torch.obs import JsonlSink, SpanRecorder

        recorder = SpanRecorder(sink=JsonlSink(args.trace_out))
    farm = BerFarm(
        codes=(args.codes or codes).split(","),
        ebn0_dbs=[float(e) for e in ebn0.split(",")],
        paths=tuple((args.paths or paths).split(",")),
        frames_per_point=args.frames or frames,
        frame_budget=args.frame_budget,
        batch_frames=args.batch_frames,
        seed=args.seed,
        confidence=args.confidence,
        recorder=recorder,
        device=args.device,
    )
    print(
        f"ber-farm: {len(farm.codes)} codes x {len(farm.ebn0_dbs)} Eb/N0 "
        f"x {len(farm.paths)} paths, "
        f"{farm.n_batches * farm.batch_frames} frames/point on {farm.device}"
    )
    points = farm.run(progress=lambda p: print(_point_row(p), flush=True))

    from .gate import run_gate

    verdicts = run_gate(points)
    failed = [v for v in verdicts if not v.passed]
    for v in verdicts:
        print(f"gate {'PASS' if v.passed else 'FAIL'} {v.label}: {v.reason}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(farm_to_json(points, verdicts), f, indent=2)
        print(f"wrote {args.out}")
    if recorder is not None:
        recorder.close()
        print(f"progress spans -> {args.trace_out}")
    print(
        f"ber-gate: {len(verdicts) - len(failed)}/{len(verdicts)} pass"
    )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
