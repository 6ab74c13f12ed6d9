"""Device-profile adapter: modelled device-memory traffic, operations,
trip-count depth and roofline terms per engine dispatch, the port of the
reference's ``obs/profile.py`` (DESIGN.md §12).

It folds three accounting layers into one record per dispatch that the
span layer attaches:

  * **interface bytes**: the ``kernels/traffic.py`` rules, a kernel's
    traffic is its interface, and the stages around it are charged by
    the same materialise-at-the-boundary model.  The one-pass streaming
    route takes ``traffic.one_pass_stream_traffic`` as it is; the other
    routes use the same shape arithmetic inline (the phi round trip of
    the two-pass batch decode, transfer-matrix formation and scan levels
    for the time-parallel decode, two circulations for WAVA).
  * **trip-count depth**: the sequential-dependency model, forward and
    traceback loops for sequential paths, ``3*tile + log2(tiles)`` for
    the time-parallel scan.
  * **roofline terms**: ``roofline.H100`` by default, ``t_compute =
    flops/peak``, ``t_memory = bytes/bw``, the bottleneck label and the
    arithmetic intensity; ``achieved(wall)`` turns a measured dispatch
    wall into achieved-over-peak fractions.

Every number equals the reference's for the same decoder, route and
cell; only the roofline differs (an H100 at 700 W in place of a TPU
v5e).  The operation count is the reference's dense fused-matmul model,
``2*T'*F*S*(B+S)``, not the work the kernels execute: at ccsds-k7 and
rho = 2 it counts 8,704 operations a frame-step, 12.4x the 703 that K1
executes (the distinct branch metrics, an add per slot and R - 1
compares per state, the renorm; ``chip_smoke.py``'s ``acs_bound``
counts those), 6.7x at lte-tbcc and 2.4x at gsm-cs1.  So
``achieved_flops_frac`` overstates how much of the card's arithmetic a
dispatch uses by that factor; ``achieved_hbm_frac`` prices the
interface bytes, a floor of what moves.  On the CPU the "achieved"
fractions price CPU walls against the H100's roof, a trend signal
between runs, not a utilisation.

The reference's ``measured_depth`` lowers a jitted function and counts
loop trips in its HLO (``hlocount.total_trip_count``).  It is not mapped:
the port's sequential depth is inside its kernels (K1's T radix steps
are one launch), where no operation stream sees it, so it raises
``NotImplementedError``; ``depth`` stays the model.

Everything is shape arithmetic; profiles are cached per (spec, path,
cell), so a dispatch with tracing on pays one dict lookup.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

from repro_torch.core.trellis import CodeSpec, build_acs_tables
from repro_torch.roofline import H100, HW

__all__ = ["DispatchProfile", "dispatch_profile", "measured_depth"]

# decode routes the adapter models: the engine's routing-table labels
# plus the session (chunk-multi) dispatch
_PATHS = (
    "batch", "time_parallel", "stream", "wava", "sharded", "session"
)


@dataclasses.dataclass(frozen=True)
class DispatchProfile:
    """Modelled cost of one dispatched (code, path, F, T) cell."""

    path: str
    f_cell: int
    n_stages: int
    hbm_bytes: int        # interface bytes (traffic.py rules)
    flops: float          # dense fused-matmul model (2*T'*F*S*(B+S))
    depth: int            # modelled sequential trip count
    hw_name: str = H100.name
    peak_flops: float = H100.peak_flops
    hbm_bw: float = H100.hbm_bw

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, operations per device-memory byte."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def span_attrs(self) -> dict:
        """The attributes the engine attaches to its dispatch spans (flat,
        JSON-able)."""
        return {
            "hbm_bytes_modeled": int(self.hbm_bytes),
            "flops_modeled": float(self.flops),
            "intensity": round(self.intensity, 4),
            "depth_modeled": int(self.depth),
            "t_memory_us": round(self.t_memory * 1e6, 3),
            "t_compute_us": round(self.t_compute * 1e6, 3),
            "bottleneck": self.bottleneck,
            "hw": self.hw_name,
        }

    def achieved(self, wall_s: float, n_devices: int = 1) -> dict:
        """Achieved over peak at a measured dispatch wall time (see the
        module docstring on what the operation fraction overstates)."""
        if wall_s <= 0:
            return {}
        dev = max(n_devices, 1)
        bw = self.hbm_bytes / wall_s / dev
        fl = self.flops / wall_s / dev
        return {
            "wall_s": wall_s,
            "achieved_hbm_Bps": bw,
            "achieved_hbm_frac": bw / self.hbm_bw,
            "achieved_flops": fl,
            "achieved_flops_frac": fl / self.peak_flops,
        }


def _two_pass_batch_bytes(T, F, S, R, B, W_bytes, mm) -> int:
    """Two-pass decode: forward (blocks in, phi out, lam carry) +
    traceback (phi read back, bits out), the §8 phi round trip."""
    phi = T * F * W_bytes
    return int(
        T * F * B * mm          # branch-metric blocks in
        + (B + S) * S * R * mm  # fused weight matrix
        + 2 * F * S * 4         # lam in/out
        + 2 * phi               # phi: write forward, read traceback
        + F * T * 2 * 4         # bits out (rho=2 stages, int32)
    )


def _profile_key(dec, path: str, f_cell: int, n_stages: int):
    return (
        dec.spec, dec.rho, path, int(f_cell), int(n_stages),
        dec.decision_depth, bool(dec.ring_packed),
        dec.precision.matmul_dtype.itemsize,
        dec.transfer_tile,
    )


@functools.lru_cache(maxsize=512)
def _profile_cached(
    spec: CodeSpec, rho: int, path: str, f_cell: int, n_stages: int,
    decision_depth: int, packed: bool, mm: int,
    transfer_tile: Optional[int], hw: HW,
) -> DispatchProfile:
    from repro_torch.core.kernel_geometry import (
        pick_transfer_tile,
        ring_dtype,
        ring_words,
    )

    tables = build_acs_tables(spec, rho)
    S, R, B = tables.n_states, tables.n_slots, tables.llr_block
    T = max(-(-n_stages // rho), 1)
    F = max(int(f_cell), 1)
    D = max(decision_depth // rho, 1)
    W_bytes = ring_words(S, packed) * ring_dtype(packed).itemsize

    # fused-ACS core: one (B+S)-contraction matmul per step per frame
    acs_flops = 2.0 * T * F * S * (B + S)

    if path in ("stream", "session"):
        # the §8 one-pass accounting, straight from traffic.py's static
        # interface model (survivors stay in K2's ring)
        from repro_torch.kernels.traffic import one_pass_stream_traffic

        tr = one_pass_stream_traffic(
            n_stages=max(T * rho, rho), n_frames=F, spec=spec, rho=rho,
            decision_depth=max(D * rho, rho), xla="static",
        )
        bytes_ = int(tr.total)
        depth = T + D  # forward tiles + flush traceback
        flops = acs_flops
    elif path == "time_parallel":
        tile = pick_transfer_tile(T, transfer_tile)
        n_tiles = max(-(-T // tile), 1)
        levels = max(int(math.ceil(math.log2(n_tiles))), 0) if (
            n_tiles > 1
        ) else 0
        tm = n_tiles * S * S * 4  # one f32 transfer matrix per tile
        bytes_ = int(
            T * F * B * mm                  # formation reads the blocks
            + (B + S) * S * R * mm
            + tm                            # formation writes matrices
            + 2 * tm * max(levels, 1)       # scan levels read+write
            + _two_pass_batch_bytes(T, F, S, R, B, W_bytes, mm)  # recovery
        )
        # formation folds the S-entry-state axis into the batch (§9)
        flops = acs_flops * (1.0 + S / max(F, 1)) + (
            2.0 * (S ** 3) * n_tiles * max(levels, 1)
        )
        depth = 3 * tile + levels
    elif path == "wava":
        # two wrap-around circulations of the two-pass decode (§7)
        bytes_ = 2 * _two_pass_batch_bytes(T, F, S, R, B, W_bytes, mm)
        flops = 2.0 * acs_flops
        depth = 2 * 2 * T
    else:  # batch / sharded (per-shard program == the batch decode)
        bytes_ = _two_pass_batch_bytes(T, F, S, R, B, W_bytes, mm)
        flops = acs_flops
        depth = 2 * T  # forward scan + traceback scan
    return DispatchProfile(
        path=path, f_cell=F, n_stages=int(n_stages),
        hbm_bytes=int(bytes_), flops=float(flops), depth=int(depth),
        hw_name=hw.name, peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
    )


def dispatch_profile(dec, path: str, f_cell: int, n_stages: int,
                     hw: HW = H100) -> DispatchProfile:
    """Profile of dispatching ``f_cell`` frames x ``n_stages`` stages of
    ``dec``'s code down the named route.  ``dec`` is a
    ``core.decoder.ViterbiDecoder``; unknown paths take the batch model
    (the engine's default route)."""
    if path not in _PATHS:
        path = "batch"
    return _profile_cached(*_profile_key(dec, path, f_cell, n_stages), hw)


def measured_depth(fn, *args) -> int:
    """Not mapped (module docstring): raises ``NotImplementedError``."""
    raise NotImplementedError(
        "measured_depth counts XLA loop trips; the port's sequential depth "
        "is inside its kernels (K1's radix steps are one launch), where no "
        "operation stream sees it: use DispatchProfile.depth, the model")
