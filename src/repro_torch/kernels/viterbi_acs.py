"""K1 — the fused ACS forward pass as a hand-written CUDA kernel for Hopper.

Replaces ``acs_forward_pallas`` (body ``_acs_kernel``) of the reference's
``src/repro/kernels/viterbi_acs.py``.  The kernel source is
``csrc/acs_forward.cu``; its header comment gives the design and what
bounds it on an H100.

Build and binding: at the first call on a CUDA tensor, ``nvcc`` compiles
the source for ``sm_90a`` into a shared library with a plain C interface
under ``build/torch_ext/`` of the checkout (named by a hash of the source
and flags, so an edited source is rebuilt), and ``ctypes`` loads it.
Nothing is built or loaded at import, so this module imports where there
is no ``nvcc``.  A failed build or launch raises; nothing runs the plain
version in its place on the card.

``acs_forward`` takes the plain version (``ref.acs_forward_ref``) only
for tensors that lie on the CPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core.backend import is_hopper
from repro_torch.core.kernel_geometry import (
    SLOT_BITS,
    check_packable,
    k1_block_frames,
    ring_dtype,
    ring_words,
)
from repro_torch.core.semiring import check_semiring

from .ref import acs_forward_ref

__all__ = ["acs_forward", "build", "SMEM_LIMIT_BYTES"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "acs_forward.cu",)
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
# dynamic shared memory one H100 block may opt in to
SMEM_LIMIT_BYTES = 232448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.isfile(cand) else None


def build() -> Path:
    """Compile ``csrc/acs_forward.cu`` (once per source content) and return
    the shared library's path.  ``nvcc``'s report (registers, shared
    memory, spills) is kept beside it as ``<name>.log``."""
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    out = BUILD_DIR / f"acs_forward_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the K1 CUDA kernel cannot be built"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        [nvcc, *_NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
        capture_output=True, text=True,
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{res.stderr}"
        )
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.acs_forward_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        lib.acs_forward_launch.restype = ctypes.c_int
        lib.acs_forward_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.acs_forward_smem_bytes.restype = ctypes.c_longlong
        lib.acs_forward_error_string.argtypes = [ctypes.c_int]
        lib.acs_forward_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


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
):
    """Run the fused forward pass.  Returns (lam_final (F, S) f32, phi).

    phi is (T, F, S) int8 slot indices, or (T, F, S//16) int32 when
    ``pack_survivors`` (rho <= 2).  On CUDA tensors this launches K1 and
    adds one to ``acs_forward.launches``; on CPU tensors it runs
    ``acs_forward_ref``.
    """
    check_semiring(semiring)
    devices = {blocks.device, lam0.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"acs_forward: inputs on several devices {devices}")
    kw = dict(
        n_states=n_states, n_slots=n_slots, carry_dtype=carry_dtype,
        matmul_dtype=matmul_dtype, renorm=renorm,
        pack_survivors=pack_survivors,
    )
    if blocks.device.type == "cpu":
        return acs_forward_ref(blocks, lam0, w, **kw)
    if blocks.device.type != "cuda":
        raise ValueError(f"acs_forward: unsupported device {blocks.device}")
    return _launch(blocks, lam0, w, **kw)


acs_forward.launches = 0  # K1 launches in this process (set to 0 to count a run)


def _launch(blocks, lam0, w, *, n_states, n_slots, carry_dtype,
            matmul_dtype, renorm, pack_survivors):
    dev = blocks.device
    if not is_hopper(dev):
        raise RuntimeError(
            f"K1 is compiled for sm_90a; {torch.cuda.get_device_name(dev)} "
            f"has compute capability {torch.cuda.get_device_capability(dev)}"
        )
    S, R = n_states, n_slots
    if R not in SLOT_BITS:
        raise ValueError(f"acs_forward: n_slots must be one of {list(SLOT_BITS)}")
    for name, dt in (("matmul_dtype", matmul_dtype), ("carry_dtype", carry_dtype)):
        if dt not in _DTYPE_CODES:
            raise ValueError(f"acs_forward: {name}={dt}; K1 takes float32 or bfloat16")
    if pack_survivors:
        check_packable(S, R)
    if blocks.dim() != 3:
        raise ValueError(f"acs_forward: blocks must be (T, F, B), got {tuple(blocks.shape)}")
    T, F, B = blocks.shape
    for name, x, shape in (
        ("blocks", blocks, (T, F, B)),
        ("lam0", lam0, (F, S)),
        ("w", w, (B + S, S * R)),
    ):
        if tuple(x.shape) != shape:
            raise ValueError(f"acs_forward: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32:
            raise ValueError(f"acs_forward: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"acs_forward: {name} must be contiguous")
    BF = k1_block_frames(S)
    lib = _library()
    smem = lib.acs_forward_smem_bytes(B, S, R, BF)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"acs_forward: W and the staged blocks need {smem} bytes of "
            f"shared memory, more than a block's {SMEM_LIMIT_BYTES}"
        )
    lam_out = torch.empty((F, S), dtype=torch.float32, device=dev)
    phi = torch.empty(
        (T, F, ring_words(S, pack_survivors)),
        dtype=ring_dtype(pack_survivors), device=dev,
    )
    if F == 0:
        return lam_out, phi
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.acs_forward_launch(
        blocks.data_ptr(), lam0.data_ptr(), w.data_ptr(),
        lam_out.data_ptr(), phi.data_ptr(),
        T, F, B, S, R, BF,
        _DTYPE_CODES[matmul_dtype], _DTYPE_CODES[carry_dtype],
        int(renorm), int(pack_survivors), index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.acs_forward_error_string(err).decode()}"
        )
    acs_forward.launches += 1
    return lam_out, phi
