"""K1, K2 and K3 — the kernels of the reference, hand-written in CUDA for
Hopper — K4, the compose of the scans, which the reference leaves to
XLA, and K6, the BCJR's within-tile sweeps, which the reference runs as
``lax.scan``s.

  * K1, ``acs_forward`` (``csrc/acs_forward.cu``), replaces
    ``acs_forward_pallas`` (body ``_acs_kernel``) of the reference's
    ``src/repro/kernels/viterbi_acs.py``: the fused ACS forward pass.
  * K2, ``acs_decode_fused`` (``csrc/acs_decode_fused.cu``), replaces
    ``acs_decode_fused_pallas`` (body ``_fused_decode_kernel``): the
    one-pass time-tiled decode, ACS and sliding-window traceback in one
    kernel.
  * K3, ``transfer_matrix`` (``csrc/transfer_matrix.cu``), replaces
    ``transfer_matrix_pallas`` (body ``_transfer_kernel``): the per-tile
    transfer matrices of the time-parallel decode and of the BCJR.
  * K4, ``semiring_compose`` (``csrc/semiring_compose.cu``), replaces no
    Pallas kernel: the semiring product of (S x S) matrices that
    ``Semiring.matmul`` runs at every level of ``associative_scan``,
    where the reference broadcasts and reduces.
  * K6, ``bcjr_sweep`` (``csrc/bcjr_sweep.cu``), replaces no Pallas
    kernel: the within-tile alpha sweep of ``bcjr_llrs`` (K6-F), and its
    beta sweep with the LLR combine fused in (K6-B), two launches a call
    where the plain versions step each tile in Python.

K1-K3 share the ACS step of ``csrc/acs_step.cuh``; each source's header
comment gives its design and what bounds it on an H100.  K1 and K3 take
``semiring``, as the reference's kernels do: ``"tropical"`` (the slot
max) or ``"logprob"`` (the max-normalised logsumexp of the BCJR), and so
does K4.  K6 is LOGPROB only.
``launches`` counts every launch of a kernel, ``logprob_launches``
those of its LOGPROB variant, and K6's ``backward_launches`` those of
K6-B.

The gather.  K1 and K3 at both semirings, and K2, form each potential as
a branch metric plus the one predecessor metric that W's metric half
routes, so they take only a W whose metric half is the shift register's
one-hot: ``gather_operands`` checks that (``kernel_geometry.gather_tables``)
and raises ``ValueError`` before any launch on another W; there is no
dense fallback.  It reads W on the host, so a caller that launches often
with one W makes its operands once and passes them (``operands=``), as
``ops.device_tables`` does once per tables and device; without them
each launch checks W itself.

Build and binding: at the first call on a CUDA tensor, ``nvcc`` compiles
each kernel's source for ``sm_90a`` into a shared library of its own with
a plain C interface under ``build/torch_ext/`` of the checkout (named by
a hash of the source, the shared header and the flags, so an edited
source is rebuilt), and ``ctypes`` loads it.  K3's source is compiled as
``K3_PARTS`` translation units, one ``nvcc`` each, side by side, then
linked into its library.  Nothing is built or loaded at import, so this
module imports where there is no ``nvcc``.  A failed build or launch,
or a card the kernels are not built for, raises :class:`KernelError`,
and so does every other exception of a wrapper on card tensors (a
refusal of their shapes or of W is a :class:`KernelRefusal`, a
``KernelError`` and a ``ValueError``); nothing runs the plain version
in its place on the card, and the serving engine lets it through every
one of its fault guards.

The wrappers take the plain versions (``ref.py``) only for tensors that
lie on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core.backend import is_hopper
from repro_torch.core.kernel_geometry import (
    K3_MAX_STATES,
    SLOT_BITS,
    SMEM_LIMIT_BYTES,
    STAGE_STEPS,
    check_packable,
    gather_stage_steps,
    gather_tables,
    k1_smem_bytes,
    k2_block_frames,
    k2_frame_bytes,
    k2_smem_bytes,
    k3_block_frames,
    k3_smem_bytes,
    ring_dtype,
    ring_words,
)
from repro_torch.core.semiring import check_semiring, get_semiring

from .ref import (
    acs_decode_fused_ref,
    acs_forward_ref,
    bcjr_backward_ref,
    bcjr_forward_ref,
    transfer_matrix_ref,
)

__all__ = [
    "acs_forward", "acs_decode_fused", "transfer_matrix", "semiring_compose",
    "bcjr_sweep", "build", "bind",
    "gather_operands", "GatherOperands", "route_index", "sweep_operands", "SweepOperands", "KernelError", "KernelRefusal", "SMEM_LIMIT_BYTES",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
# one shared library per kernel, each built from its own source
KERNELS = ("acs_forward", "acs_decode_fused", "transfer_matrix", "semiring_compose",
           "bcjr_sweep")
_HEADERS = (_CSRC / "acs_step.cuh",)
# the checkout's build/ directory (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
_NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)
# K3's instantiations are split over this many translation units
# (K3_PART in csrc/transfer_matrix.cu), so that its build takes about as
# long as its largest part
K3_PARTS = 5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SEMIRING_CODES = {"tropical": 0, "logprob": 1}  # acs_step.cuh's SemiringCode

# CUDA's limit on a grid's y extent: K3's grid is (tiles, frame blocks)
MAX_GRID_Y = 65535

_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel could not be built or launched: no ``nvcc``, a failed
    compile or link, a card other than sm_90, an error code from the
    launch, or any other exception of a wrapper on card tensors.  Never a
    transient fault: retrying or degrading would only hide that the
    kernel did not run."""


class KernelRefusal(KernelError, ValueError):
    """A wrapper refused card tensors it cannot launch on: a shape, dtype,
    W or geometry the kernel does not take, or a block past the card's
    shared memory or grid.  A ``ValueError``, as the same refusal is on
    the CPU, and a ``KernelError``, so that no caller serves the request
    by another path in the kernel's place."""


def _card_errors(launch):
    """Make every exception out of ``launch`` (which runs only for card
    tensors) a ``KernelError``: a ``ValueError`` becomes a
    ``KernelRefusal`` with its message, anything else (a failed
    allocation, a CUDA error) a ``KernelError`` that names the kernel."""

    @functools.wraps(launch)
    def checked(*args, **kwargs):
        try:
            return launch(*args, **kwargs)
        except KernelError:
            raise
        except ValueError as e:
            raise KernelRefusal(str(e)) from e
        except Exception as e:  # noqa: BLE001 — retyped, never swallowed
            raise KernelError(f"{launch.__name__} on the card: {e!r}") from e

    return checked


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.isfile(cand) else None


def build(name: str = "acs_forward") -> Path:
    """Compile ``csrc/<name>.cu`` (once per content of the source and the
    shared header) and return the shared library's path.  ``nvcc``'s
    report (registers, shared memory, spills) is kept beside it as
    ``<library>.log``."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}; one of {KERNELS}")
    src = _CSRC / f"{name}.cu"
    parts = K3_PARTS if name == "transfer_matrix" else 0
    digest = hashlib.sha256()
    for path in (src, *_HEADERS):
        digest.update(path.read_bytes())
    digest.update(f"{' '.join(_NVCC_FLAGS)} parts={parts}".encode())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _find_nvcc()
    if nvcc is None:
        raise KernelError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            f"the CUDA kernel {name} cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not parts:
        runs = [[nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)]]
    else:  # one object per part, side by side, then one link
        objs = [tmp.with_name(f"{tmp.name}.{p}.o") for p in range(parts)]
        compile_flags = [f for f in _NVCC_FLAGS if f != "-shared"]
        runs = [[nvcc, *compile_flags, f"-DK3_PART={p}", "-c", "-o", str(o), str(src)]
                for p, o in enumerate(objs)]
    log = ""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in runs]
    for proc in procs:
        stdout, stderr = proc.communicate()
        log += stdout + stderr
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed on {src.name} with exit code {proc.returncode}:\n"
                f"{stderr}"
            )
    if parts:
        res = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        for o in objs:
            o.unlink()
        if res.returncode != 0:
            raise KernelError(f"linking {name}'s parts failed:\n{res.stderr}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = bind(build(name), name)
    return _libs[name]


def bind(path: Path, name: str) -> ctypes.CDLL:
    """Load the library at ``path``, built from ``csrc/<name>.cu``, and
    declare its C interface."""
    lib = ctypes.CDLL(str(path))
    if name == "acs_forward":
        lib.acs_forward_gather_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.acs_forward_gather_launch.restype = ctypes.c_int
    elif name == "acs_decode_fused":
        lib.acs_decode_fused_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 16
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.acs_decode_fused_launch.restype = ctypes.c_int
        lib.acs_decode_fused_blocks_per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
        lib.acs_decode_fused_blocks_per_sm.restype = ctypes.c_int
    elif name == "semiring_compose":
        operand = [ctypes.c_void_p] + [ctypes.c_longlong] * 3
        lib.semiring_compose_launch.argtypes = (
            operand * 2 + [ctypes.c_void_p, ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        lib.semiring_compose_launch.restype = ctypes.c_int
    elif name == "bcjr_sweep":
        lib.bcjr_sweep_launch.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
            + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        )
        lib.bcjr_sweep_launch.restype = ctypes.c_int
    else:
        lib.transfer_matrix_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.transfer_matrix_launch.restype = ctypes.c_int
    err_string = getattr(lib, f"{name}_error_string")
    err_string.argtypes = [ctypes.c_int]
    err_string.restype = ctypes.c_char_p
    return lib


def _check_card(dev: torch.device, kernel: str) -> None:
    if not is_hopper(dev):
        raise KernelError(
            f"{kernel} is compiled for sm_90a; "
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{torch.cuda.get_device_capability(dev)}"
        )


def _check_dtypes(who: str, **dtypes) -> None:
    for name, dt in dtypes.items():
        if dt not in _DTYPE_CODES:
            raise ValueError(f"{who}: {name}={dt}; the kernel takes float32 or bfloat16")


def _check_inputs(who: str, **named) -> None:
    """Each value is (tensor, expected shape, expected dtype)."""
    for name, (x, shape, dtype) in named.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
        if x.dtype != dtype:
            raise ValueError(f"{who}: {name} must be {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")


def _one_device(who: str, *tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{who}: inputs on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise KernelError(f"{name} launch failed: {msg}")


class GatherOperands(NamedTuple):
    """What K1, K2 and K3 take in place of W."""

    cols: torch.Tensor  # (B, n_u) float32: Theta's distinct columns
    cid: torch.Tensor  # (S*R,) int16: each column's index in ``cols``


def gather_operands(w: torch.Tensor, llr_block: int, n_states: int,
                    n_slots: int) -> GatherOperands:
    """Check W for the gathered kernels and derive their operands, on
    W's device, with one host read of W.

    ``kernel_geometry.gather_tables`` raises ``ValueError`` unless W's
    metric half is the shift register's one-hot.  Theta (W's LLR half)
    has few distinct columns (at most 2^B for a code's +-1 patterns), so
    the kernels form one branch metric per distinct column and (frame,
    step)."""
    host = w.detach().to("cpu", torch.float32)
    theta, _ = gather_tables(host, llr_block, n_states, n_slots)
    cols, cid = torch.unique(theta.T, dim=0, return_inverse=True)
    return GatherOperands(
        cols.T.contiguous().to(w.device), cid.to(torch.int16).to(w.device)
    )


def _operands(who: str, w: torch.Tensor, operands: Optional[GatherOperands],
              llr_block: int, n_states: int, n_slots: int) -> GatherOperands:
    """The caller's operands, checked for shape and device, or W's."""
    if operands is None:
        return gather_operands(w, llr_block, n_states, n_slots)
    cols, cid = operands
    if (cols.dim() != 2 or cols.shape[0] != llr_block or cols.dtype != torch.float32
            or tuple(cid.shape) != (n_states * n_slots,) or cid.dtype != torch.int16
            or cols.device != w.device or cid.device != w.device
            or not cols.is_contiguous()):
        raise ValueError(f"{who}: operands do not fit W {tuple(w.shape)} on {w.device}")
    return operands


def acs_forward(
    blocks: torch.Tensor,  # (T, F, B) float32
    lam0: torch.Tensor,  # (F, S) float32
    w: torch.Tensor,  # (B+S, S*R) float32
    *,
    n_states: int,
    n_slots: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    pack_survivors: bool = False,
    semiring: str = "tropical",
    operands: Optional[GatherOperands] = None,
):
    """Run the fused forward pass.  Returns (lam_final (F, S) f32, phi).

    phi is (T, F, S) int8 slot indices, or (T, F, S//16) int32 when
    ``pack_survivors`` (rho <= 2).  ``semiring`` is the slot reduction:
    ``"tropical"`` (max) or ``"logprob"`` (logsumexp; phi still holds
    the first argmax).  On CUDA tensors this launches K1 and adds one to
    ``acs_forward.launches`` (and, at LOGPROB, to
    ``acs_forward.logprob_launches``); on CPU tensors it runs
    ``acs_forward_ref``.  K1 takes only a W whose metric half is the shift
    register's one-hot, at both semirings (``gather_operands`` raises
    ``ValueError`` before any launch on another; ``operands``, if given,
    are ``gather_operands(w, ...)`` made once by the caller).
    """
    check_semiring(semiring)
    dev = _one_device("acs_forward", blocks, lam0, w)
    kw = dict(
        n_states=n_states, n_slots=n_slots, carry_dtype=carry_dtype,
        matmul_dtype=matmul_dtype, renorm=renorm,
        pack_survivors=pack_survivors, semiring=semiring,
    )
    if dev.type == "cpu":
        return acs_forward_ref(blocks, lam0, w, **kw)
    return _launch_k1(blocks, lam0, w, operands=operands, **kw)


acs_forward.launches = 0  # K1 launches in this process (set to 0 to count a run)
acs_forward.logprob_launches = 0  # of which K1-LOGPROB


def _count_launch(kernel, semiring: str) -> None:
    kernel.launches += 1
    if semiring == "logprob":
        kernel.logprob_launches += 1


@_card_errors
def _launch_k1(blocks, lam0, w, *, n_states, n_slots, carry_dtype,
               matmul_dtype, renorm, pack_survivors, semiring, operands):
    dev = blocks.device
    _check_card(dev, "K1")
    S, R = n_states, n_slots
    if R not in SLOT_BITS:
        raise ValueError(f"acs_forward: n_slots must be one of {list(SLOT_BITS)}")
    _check_dtypes("acs_forward", matmul_dtype=matmul_dtype, carry_dtype=carry_dtype)
    if pack_survivors:
        check_packable(S, R)
    if blocks.dim() != 3:
        raise ValueError(f"acs_forward: blocks must be (T, F, B), got {tuple(blocks.shape)}")
    T, F, B = blocks.shape
    f32 = torch.float32
    _check_inputs(
        "acs_forward", blocks=(blocks, (T, F, B), f32),
        lam0=(lam0, (F, S), f32), w=(w, (B + S, S * R), f32),
    )
    ops = _operands("acs_forward", w, operands, B, S, R)
    n_cols = ops.cols.shape[1]
    smem = k1_smem_bytes(S, B, n_cols)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"acs_forward: a block needs {smem} bytes of shared memory, more "
            f"than its {SMEM_LIMIT_BYTES}"
        )
    lam_out = torch.empty((F, S), dtype=torch.float32, device=dev)
    phi = torch.empty(
        (T, F, ring_words(S, pack_survivors)),
        dtype=ring_dtype(pack_survivors), device=dev,
    )
    if F == 0:
        return lam_out, phi
    lib = _library("acs_forward")
    err = lib.acs_forward_gather_launch(
        blocks.data_ptr(), lam0.data_ptr(), ops.cols.data_ptr(),
        ops.cid.data_ptr(), lam_out.data_ptr(), phi.data_ptr(),
        T, F, B, S, R, n_cols, gather_stage_steps(S, B, n_cols, False),
        _DTYPE_CODES[matmul_dtype], _DTYPE_CODES[carry_dtype], int(renorm),
        int(pack_survivors), _SEMIRING_CODES[semiring], smem,
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, "acs_forward", err)
    _count_launch(acs_forward, semiring)
    return lam_out, phi


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def acs_decode_fused(
    blocks: torch.Tensor,  # (T, F, B) float32, T a multiple of the tile
    lam0: torch.Tensor,  # (F, S) float32
    hist0: torch.Tensor,  # (D, F, W) entry ring, chronological
    w: torch.Tensor,  # (B+S, S*R) float32
    *,
    n_states: int,
    n_slots: int,
    k: int,
    rho: int,
    time_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    pack_survivors: bool = False,
    operands: Optional[GatherOperands] = None,
):
    """One-pass time-tiled decode.  Returns (bits (T*rho, F) int8,
    lam (F, S) f32, hist (D, F, W)).  Tropical only: like the
    reference's K2, it takes no ``semiring``.

    bits row r is the decision for step r//rho - D of this call (rows of
    negative steps replay ``hist0``); hist is the exit ring, the newest
    D steps in time order, int8 (W = S) or packed int32 (W = S//16).
    The tile is ``min(time_tile, T)`` and must divide both T and D.  On
    CUDA tensors this launches K2 and adds one to
    ``acs_decode_fused.launches``; on CPU tensors it runs
    ``acs_decode_fused_ref``.  K2 takes only a W whose metric half is the
    shift register's one-hot (``gather_operands`` raises ``ValueError``
    before any launch on another; ``operands``, if given, are
    ``gather_operands(w, ...)`` made once by the caller).
    """
    dev = _one_device("acs_decode_fused", blocks, lam0, hist0, w)
    kw = dict(
        n_states=n_states, n_slots=n_slots, k=k, rho=rho, time_tile=time_tile,
        carry_dtype=carry_dtype, matmul_dtype=matmul_dtype, renorm=renorm,
        pack_survivors=pack_survivors,
    )
    if dev.type == "cpu":
        return acs_decode_fused_ref(blocks, lam0, hist0, w, **_k2_args(blocks, hist0, **kw))
    return _launch_k2(blocks, lam0, hist0, w, operands=operands, **kw)


acs_decode_fused.launches = 0  # K2 launches in this process (set to 0 to count a run)


def _k2_args(blocks, hist0, *, n_states, n_slots, time_tile, pack_survivors, **kw):
    """K2's checks on both devices; its keyword arguments, the tile
    ``min(time_tile, T)``."""
    S, R = n_states, n_slots
    if blocks.dim() != 3 or hist0.dim() != 3:
        raise ValueError(
            "acs_decode_fused: blocks must be (T, F, B) and hist0 (D, F, W), "
            f"got {tuple(blocks.shape)} and {tuple(hist0.shape)}"
        )
    T, D = blocks.shape[0], hist0.shape[0]
    if T <= 0:
        raise ValueError("acs_decode_fused: needs at least one step")
    TT = min(time_tile, T)
    if TT <= 0 or T % TT:
        raise ValueError(f"acs_decode_fused: T={T} not divisible by time_tile={TT}")
    if D % TT:
        raise ValueError(f"acs_decode_fused: depth D={D} steps not divisible by time_tile={TT}")
    if pack_survivors:
        check_packable(S, R)
    W, ring_dt = ring_words(S, pack_survivors), ring_dtype(pack_survivors)
    if hist0.shape[2] != W or hist0.dtype != ring_dt:
        raise ValueError(
            f"acs_decode_fused: hist0 {tuple(hist0.shape)}/{hist0.dtype} does "
            f"not match pack_survivors={pack_survivors} (want (*, F, {W}) {ring_dt})"
        )
    return dict(n_states=S, n_slots=R, time_tile=TT, pack_survivors=pack_survivors, **kw)


@_card_errors
def _launch_k2(blocks, lam0, hist0, w, *, operands, **kw):
    dev = blocks.device
    _check_card(dev, "K2")
    kw = _k2_args(blocks, hist0, **kw)
    S, R, TT, k, rho = (kw[a] for a in ("n_states", "n_slots", "time_tile", "k", "rho"))
    carry_dtype, matmul_dtype = kw["carry_dtype"], kw["matmul_dtype"]
    renorm, pack_survivors = kw["renorm"], kw["pack_survivors"]
    if R not in SLOT_BITS or R != 1 << rho:
        raise ValueError(f"acs_decode_fused: n_slots={R} must be 2**rho, rho in 1..4")
    if S != 1 << (k - 1):
        raise ValueError(f"acs_decode_fused: n_states={S} must be 2**(k-1), k={k}")
    _check_dtypes("acs_decode_fused", matmul_dtype=matmul_dtype, carry_dtype=carry_dtype)
    T, F, B = blocks.shape
    D, W = hist0.shape[0], hist0.shape[2]
    f32 = torch.float32
    _check_inputs(
        "acs_decode_fused", blocks=(blocks, (T, F, B), f32),
        lam0=(lam0, (F, S), f32), hist0=(hist0, (D, F, W), hist0.dtype),
        w=(w, (B + S, S * R), f32),
    )
    ops = _operands("acs_decode_fused", w, operands, B, S, R)
    n_cols = ops.cols.shape[1]
    BF, in_smem = k2_block_frames(S, B, n_cols, D, TT, pack_survivors, F,
                                  _sm_count(dev))
    smem = k2_smem_bytes(S, B, n_cols, D, TT, pack_survivors, BF, in_smem)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"acs_decode_fused: a block's staging needs {smem} bytes of "
            f"shared memory, more than its {SMEM_LIMIT_BYTES}"
        )
    bits = torch.empty((T * rho, F), dtype=torch.int8, device=dev)
    lam_out = torch.empty((F, S), dtype=torch.float32, device=dev)
    hist_out = torch.empty((D, F, W), dtype=hist0.dtype, device=dev)
    if F == 0:
        return bits, lam_out, hist_out
    ring = None
    if not in_smem:  # every block's rings and maps, in device memory
        grid = -(-F // BF)
        ring = torch.empty(grid * BF * k2_frame_bytes(S, D, TT, pack_survivors),
                           dtype=torch.uint8, device=dev)
    lib = _library("acs_decode_fused")
    err = lib.acs_decode_fused_launch(
        blocks.data_ptr(), lam0.data_ptr(), hist0.data_ptr(),
        ops.cols.data_ptr(), ops.cid.data_ptr(), bits.data_ptr(),
        lam_out.data_ptr(), hist_out.data_ptr(),
        None if ring is None else ring.data_ptr(),
        0 if ring is None else ring.numel(),
        T, F, B, S, R, n_cols, gather_stage_steps(S, B, n_cols, True), BF,
        D, TT, k, rho, _DTYPE_CODES[matmul_dtype], _DTYPE_CODES[carry_dtype],
        int(renorm), int(pack_survivors), smem, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, "acs_decode_fused", err)
    acs_decode_fused.launches += 1
    return bits, lam_out, hist_out


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def k2_launch_geometry(n_states: int, n_slots: int, llr_block: int,
                       n_cols: int, depth: int, tile: int, pack_survivors: bool,
                       n_frames: int) -> dict:
    """How ``acs_decode_fused`` launches K2 for these shapes on the
    current card: frames a block, rings in shared memory or not, shared
    bytes a block, grid, and the blocks an SM holds (the occupancy
    calculator; builds K2)."""
    S = n_states
    dev = torch.device("cuda", torch.cuda.current_device())
    bf, in_smem = k2_block_frames(S, llr_block, n_cols, depth, tile, pack_survivors,
                                  n_frames, _sm_count(dev))
    smem = k2_smem_bytes(S, llr_block, n_cols, depth, tile, pack_survivors, bf, in_smem)
    per_sm = _library("acs_decode_fused").acs_decode_fused_blocks_per_sm(
        S, n_slots, bf, int(pack_survivors), smem)
    return dict(block_frames=bf, rings_in_smem=in_smem, smem_bytes=smem,
                grid=-(-n_frames // bf), blocks_per_sm=per_sm)


def transfer_matrix(
    blocks: torch.Tensor,  # (T, F, B) float32, T a multiple of the tile
    w: torch.Tensor,  # (B+S, S*R) float32
    *,
    n_states: int,
    n_slots: int,
    transfer_tile: int,
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    split_dot: bool = False,
    semiring: str = "tropical",
    operands: Optional[GatherOperands] = None,
):
    """Per-tile transfer matrices M (N, F, S, S) f32 of ``semiring``
    (``"tropical"`` or ``"logprob"``), each (tile, frame) normalised by
    its max; the tile is ``min(transfer_tile, T)`` and must divide T.
    More than ``kernel_geometry.K3_MAX_STATES`` states raise
    ``ValueError`` (``k3_block_frames``).  On CUDA tensors this launches
    K3, which takes only a W whose metric half is the shift register's
    one-hot (``gather_operands`` raises on any other; ``operands``, if
    given, are ``gather_operands(w, ...)`` made once by the caller, and
    stand for that check), and adds one to ``transfer_matrix.launches`` (and, at LOGPROB, to
    ``transfer_matrix.logprob_launches``); on CPU tensors it runs
    ``transfer_matrix_ref``.
    """
    check_semiring(semiring)
    dev = _one_device("transfer_matrix", blocks, w)
    kw = dict(
        n_states=n_states, n_slots=n_slots, transfer_tile=transfer_tile,
        carry_dtype=carry_dtype, matmul_dtype=matmul_dtype,
        split_dot=split_dot, semiring=semiring,
    )
    if dev.type == "cpu":
        return transfer_matrix_ref(blocks, w, **_k3_args(blocks, **kw))
    return _launch_k3(blocks, w, operands=operands, **kw)


transfer_matrix.launches = 0  # K3 launches in this process (set to 0 to count a run)
transfer_matrix.logprob_launches = 0  # of which K3-LOGPROB


def _k3_args(blocks, *, n_states, transfer_tile, **kw):
    """K3's checks on both devices; its keyword arguments, the tile
    ``min(transfer_tile, T)``."""
    if blocks.dim() != 3:
        raise ValueError(f"transfer_matrix: blocks must be (T, F, B), got {tuple(blocks.shape)}")
    T = blocks.shape[0]
    TT = min(transfer_tile, T)
    if TT <= 0 or T % TT:
        raise ValueError(f"transfer_matrix: T'={T} not divisible by transfer_tile={TT}")
    k3_block_frames(n_states)  # raises where a row does not fit
    return dict(n_states=n_states, transfer_tile=TT, **kw)


@_card_errors
def _launch_k3(blocks, w, *, operands, **kw):
    """Checks W (``gather_operands``: its metric half must be the shift
    register's one-hot, or this raises before any launch; K3 has no dense
    fallback), then launches K3 on W's LLR half with
    ``k3_block_frames`` frames a block and ``k3_smem_bytes`` of shared
    memory."""
    dev = blocks.device
    _check_card(dev, "K3")
    kw = _k3_args(blocks, **kw)
    S, R, TT = kw["n_states"], kw["n_slots"], kw["transfer_tile"]
    carry_dtype, matmul_dtype = kw["carry_dtype"], kw["matmul_dtype"]
    split_dot, semiring = kw["split_dot"], kw["semiring"]
    if R not in SLOT_BITS:
        raise ValueError(f"transfer_matrix: n_slots must be one of {list(SLOT_BITS)}")
    _check_dtypes("transfer_matrix", matmul_dtype=matmul_dtype, carry_dtype=carry_dtype)
    T, F, B = blocks.shape
    f32 = torch.float32
    _check_inputs(
        "transfer_matrix", blocks=(blocks, (T, F, B), f32),
        w=(w, (B + S, S * R), f32),
    )
    _operands("transfer_matrix", w, operands, B, S, R)
    theta = w[:B]
    BF = k3_block_frames(S)
    if -(-F // BF) > MAX_GRID_Y:
        raise ValueError(
            f"transfer_matrix: {F} frames need more than {MAX_GRID_Y} blocks of {BF}")
    m = torch.empty((T // TT, F, S, S), dtype=torch.float32, device=dev)
    if F == 0:
        return m
    lib = _library("transfer_matrix")
    err = lib.transfer_matrix_launch(
        blocks.data_ptr(), theta.data_ptr(), m.data_ptr(),
        T, F, B, S, R, TT, BF,
        _DTYPE_CODES[matmul_dtype], _DTYPE_CODES[carry_dtype], int(split_dot),
        _SEMIRING_CODES[semiring], k3_smem_bytes(S, R),
        _device_index(dev), torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, "transfer_matrix", err)
    _count_launch(transfer_matrix, semiring)
    return m


def semiring_compose(
    a: torch.Tensor,  # (..., S, S)
    b: torch.Tensor,  # (..., S, S), the batch broadcast against a's
    *,
    semiring: str = "tropical",
    matmul_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The semiring product C = A (x) B of square (S, S) matrices over a
    broadcast batch, f32: ``Semiring.matmul``.  Operands are quantised to
    ``matmul_dtype`` and the sums taken in f32.  Non-square or mismatched
    operands, or more than ``K3_MAX_STATES`` (64) states (every matrix
    K3 forms fits), raise ``ValueError``
    on both devices.  On CUDA tensors this launches K4 over the whole
    batch (operands strided along their batch, as ``associative_scan``'s
    views are, are read where they lie) and adds one to
    ``semiring_compose.launches`` (and, at LOGPROB, to
    ``semiring_compose.logprob_launches``); an empty batch launches
    nothing.  On CPU tensors it runs the plain version,
    ``Semiring.matmul_plain``.
    """
    check_semiring(semiring)
    dev = _one_device("semiring_compose", a, b)
    S = _k4_states(a, b)
    if dev.type == "cpu":
        return get_semiring(semiring).matmul_plain(a, b, matmul_dtype)
    return _launch_k4(a, b, S, semiring=semiring, matmul_dtype=matmul_dtype)


semiring_compose.launches = 0  # K4 launches in this process (set to 0 to count a run)
semiring_compose.logprob_launches = 0  # of which K4-LOGPROB


def _k4_states(a: torch.Tensor, b: torch.Tensor) -> int:
    """K4's checks on both devices: S of two square (S, S) operands."""
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError(
            "semiring_compose: operands must be (..., S, S), got "
            f"{tuple(a.shape)} and {tuple(b.shape)}")
    S = a.shape[-1]
    if a.shape[-2] != S or tuple(b.shape[-2:]) != (S, S) or S == 0:
        raise ValueError(
            "semiring_compose: operands must be square matrices of one size, "
            f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if S > K3_MAX_STATES:
        raise ValueError(
            f"semiring_compose: {S} states do not fit (at most {K3_MAX_STATES})")
    return S


def _k4_levels(x: torch.Tensor):
    """The flattened batch of x (..., S, S) as (inner, inner stride, outer
    stride): matrix b at (b // inner) * outer + (b % inner) * inner floats,
    or None where x's rows are not contiguous, its batch takes more than
    two levels of strides, or K4's 16-byte loads would be misaligned."""
    S = x.shape[-1]
    if S > 1 and (x.stride(-1) != 1 or x.stride(-2) != S):
        return None
    levels = []  # (size, stride), innermost first; merged where they chain
    for size, stride in zip(reversed(x.shape[:-2]), reversed(x.stride()[:-2])):
        if size == 1:
            continue
        if levels and stride == levels[-1][0] * levels[-1][1]:
            levels[-1] = (levels[-1][0] * size, levels[-1][1])
        else:
            levels.append((size, stride))
    if len(levels) > 2:
        return None
    if S % 4 == 0 and (x.data_ptr() % 16 or any(st % 4 for _, st in levels)):
        return None
    (inner, inner_stride), (_, outer_stride) = levels + [(1, 0)] * (2 - len(levels))
    return inner, inner_stride, outer_stride


def _k4_operand(x: torch.Tensor, batch) -> tuple:
    """(tensor, inner, inner stride, outer stride) of x broadcast to
    ``batch``: x's own storage where ``_k4_levels`` takes it, else a
    contiguous copy."""
    if x.shape[:-2] != batch:
        x = x.expand(*batch, *x.shape[-2:])
    levels = _k4_levels(x)
    if levels is None:
        x = x.clone(memory_format=torch.contiguous_format)
        levels = _k4_levels(x)
    return (x, *levels)


@_card_errors
def _launch_k4(a, b, S, *, semiring, matmul_dtype):
    dev = a.device
    _check_card(dev, "K4")
    if S & (S - 1):
        raise ValueError(f"semiring_compose: K4 takes S a power of two, got {S}")
    f32 = torch.float32
    if (a.dtype, b.dtype, matmul_dtype) != (f32, f32, f32):
        a, b = (x.to(matmul_dtype).to(f32) for x in (a, b))
    # the scans' operands share one batch shape; broadcast_shapes costs
    # more host time than the launch
    batch = a.shape[:-2]
    if b.shape[:-2] != batch:
        batch = torch.broadcast_shapes(batch, b.shape[:-2])
    out = torch.empty((*batch, S, S), dtype=f32, device=dev)
    n = out.numel() // (S * S)
    if n == 0:
        return out
    xa, *la = _k4_operand(a, batch)
    xb, *lb = _k4_operand(b, batch)
    lib = _library("semiring_compose")
    err = lib.semiring_compose_launch(
        xa.data_ptr(), *la, xb.data_ptr(), *lb, out.data_ptr(), n, S,
        _SEMIRING_CODES[semiring], _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, "semiring_compose", err)
    _count_launch(semiring_compose, semiring)
    return out


class SweepOperands(NamedTuple):
    """What K6 takes for one direction of the sweep, in place of W."""

    cols: torch.Tensor  # (B, n_u) float32: Theta's distinct columns
    cid: torch.Tensor  # (S*R,) int16: each column's index in ``cols``
    route: torch.Tensor  # (S*R,) int16: the state each column's metric comes from
    dec: torch.Tensor  # (S,) int32: each state's rho decoded bits, bit b at b


def route_index(onehot) -> torch.Tensor:
    """(S*R,) int64: the row of the one 1 in each column of a routing
    one-hot (S, S*R), ``pred_onehot`` or ``succ_onehot``: the state whose
    metric each potential adds.  Raises ``ValueError`` unless every
    column holds exactly one 1.0 among 0.0s (then the dense sum of the
    routing half is that one product).  Reads the one-hot on the host."""
    routing = torch.as_tensor(onehot).detach().to("cpu", torch.float32)
    if routing.dim() != 2:
        raise ValueError(f"a routing one-hot is (S, S*R), got {tuple(routing.shape)}")
    rows = routing.argmax(dim=0)
    want = torch.zeros_like(routing)
    want[rows, torch.arange(routing.shape[1])] = 1.0
    if not torch.equal(routing, want):
        raise ValueError(
            "the routing half is not one 1.0 per column among 0.0s, so a "
            "potential is not one routed metric plus a branch metric"
        )
    return rows


def sweep_operands(theta, onehot, dec_bits) -> SweepOperands:
    """K6's operands of one direction, on the CPU: Theta's (B, S*R)
    distinct columns and each column's index among them, the routing index
    of ``onehot`` (``route_index``, which raises on a routing half that is
    not a one-hot) and the (S, rho) decoded bits packed one int a state."""
    theta = torch.as_tensor(theta).to("cpu", torch.float32)
    cols, cid = torch.unique(theta.T, dim=0, return_inverse=True)
    dec = torch.as_tensor(dec_bits).to("cpu", torch.int64)
    packed = (dec << torch.arange(dec.shape[1])).sum(dim=1)
    return SweepOperands(cols.T.contiguous(), cid.to(torch.int16),
                         route_index(onehot).to(torch.int16), packed.to(torch.int32))


def bcjr_sweep(
    blocks: torch.Tensor,  # (T', F, B) float32, T' a multiple of the tile
    metric: torch.Tensor,  # (N, F, S) float32: tile-entry alphas or tile-end betas
    operands: SweepOperands,
    *,
    transfer_tile: int,
    alphas: Optional[torch.Tensor] = None,  # (tt, N*F, S) float32: K6-B's input
    carry_dtype: torch.dtype = torch.float32,
    matmul_dtype: torch.dtype = torch.float32,
    renorm: bool = True,
    split_dot: bool = False,
):
    """The BCJR's within-tile sweeps over rows p*F + f (tile p, frame f).

    Without ``alphas`` (K6-F): from each tile's entry alpha, the tile's tt
    LOGPROB steps on the forward tables' operands; returns the alphas at
    boundaries 1..tt, (tt, N*F, S) f32, ``soft._alpha_scan``'s layout.
    With ``alphas`` (K6-B): from each tile's end beta, the reverse steps
    on the reversed tables' operands, and at every boundary the LLRs of
    the joint alpha + beta; returns the LLRs (F, T' * rho) f32 of
    ``bcjr_llrs``.  ``blocks`` may be strided along T' and F.  The
    precision knobs are ``AcsPrecision``'s; float32 and bfloat16 carries
    and matmul operands, anything else raises ``ValueError`` naming the
    knob, on both devices.  More than ``K3_MAX_STATES`` (64) states
    raise.  On CUDA tensors this launches K6 and adds one to
    ``bcjr_sweep.launches`` (and, for K6-B, to
    ``bcjr_sweep.backward_launches``); on CPU tensors it runs the plain
    versions, ``bcjr_forward_ref`` and ``bcjr_backward_ref``."""
    tensors = (blocks, metric, *operands) + (() if alphas is None else (alphas,))
    dev = _one_device("bcjr_sweep", *tensors)
    kw = _k6_args(blocks, metric, operands, alphas, transfer_tile=transfer_tile,
                  carry_dtype=carry_dtype, matmul_dtype=matmul_dtype, renorm=renorm,
                  split_dot=split_dot)
    if dev.type == "cpu":
        if alphas is None:
            return bcjr_forward_ref(blocks, metric, operands, **kw)
        return bcjr_backward_ref(blocks, metric, alphas, operands, **kw)
    return _launch_k6(blocks, metric, operands, alphas, **kw)


bcjr_sweep.launches = 0  # K6 launches (K6-F and K6-B) in this process
bcjr_sweep.backward_launches = 0  # of which K6-B


def _k6_args(blocks, metric, operands, alphas, *, transfer_tile, carry_dtype,
             matmul_dtype, **kw):
    """K6's checks on both devices; its keyword arguments."""
    _check_dtypes("bcjr_sweep", matmul_dtype=matmul_dtype, carry_dtype=carry_dtype)
    if blocks.dim() != 3 or metric.dim() != 3:
        raise ValueError(
            "bcjr_sweep: blocks must be (T', F, B) and the metric (N, F, S), got "
            f"{tuple(blocks.shape)} and {tuple(metric.shape)}")
    T, F, B = blocks.shape
    N, S = metric.shape[0], metric.shape[2]
    tt = transfer_tile
    if tt <= 0 or T != N * tt or metric.shape[1] != F:
        raise ValueError(
            f"bcjr_sweep: {N} tiles of {tt} steps do not make T'={T}, or the "
            f"metric's {metric.shape[1]} frames are not the blocks' {F}")
    cols, cid, route, dec = operands
    R = cid.numel() // max(S, 1)
    if R not in SLOT_BITS or S < R or S & (S - 1) or S > K3_MAX_STATES:
        raise ValueError(
            f"bcjr_sweep: S={S} states and R={R} slots; K6 takes R in "
            f"{list(SLOT_BITS)} and a power of two S in [R, {K3_MAX_STATES}]")
    if (cols.dim() != 2 or cols.shape[0] != B or cols.dtype != torch.float32
            or tuple(cid.shape) != (S * R,) or cid.dtype != torch.int16
            or tuple(route.shape) != (S * R,) or route.dtype != torch.int16
            or tuple(dec.shape) != (S,) or dec.dtype != torch.int32):
        raise ValueError(f"bcjr_sweep: operands do not fit B={B}, S={S}, R={R}")
    if blocks.dtype != torch.float32 or metric.dtype != torch.float32:
        raise ValueError("bcjr_sweep: blocks and the metric must be float32")
    if alphas is not None and (tuple(alphas.shape) != (tt, N * F, S)
                               or alphas.dtype != torch.float32):
        raise ValueError(
            f"bcjr_sweep: alphas {tuple(alphas.shape)}/{alphas.dtype}, want "
            f"{(tt, N * F, S)} float32")
    return dict(transfer_tile=tt, carry_dtype=carry_dtype, matmul_dtype=matmul_dtype, **kw)


@_card_errors
def _launch_k6(blocks, metric, operands, alphas, *, transfer_tile, carry_dtype,
               matmul_dtype, renorm, split_dot):
    dev = blocks.device
    _check_card(dev, "K6")
    if blocks.stride(-1) != 1:
        blocks = blocks.contiguous()
    metric = metric.contiguous()
    T, F, B = blocks.shape
    N, S, tt = metric.shape[0], metric.shape[2], transfer_tile
    cols, cid, route, dec = operands
    R = cid.numel() // S
    rows = N * F
    backward = alphas is not None
    if backward:
        alphas = alphas.contiguous()
        out = torch.empty((F, T * SLOT_BITS[R]), dtype=torch.float32, device=dev)
    else:
        alphas = torch.empty((tt, rows, S), dtype=torch.float32, device=dev)
        out = None
    if rows == 0:
        return out if backward else alphas
    lib = _library("bcjr_sweep")
    err = lib.bcjr_sweep_launch(
        int(backward), blocks.data_ptr(), blocks.stride(0), blocks.stride(1),
        metric.data_ptr(), cols.data_ptr(), cid.data_ptr(), route.data_ptr(),
        dec.data_ptr() if backward else None, alphas.data_ptr(),
        out.data_ptr() if backward else None, tt, F, rows, B, S, R, cols.shape[1],
        min(STAGE_STEPS, tt), _DTYPE_CODES[matmul_dtype], _DTYPE_CODES[carry_dtype],
        int(renorm), int(split_dot), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(lib, "bcjr_sweep", err)
    bcjr_sweep.launches += 1
    bcjr_sweep.backward_launches += int(backward)
    return out if backward else alphas
