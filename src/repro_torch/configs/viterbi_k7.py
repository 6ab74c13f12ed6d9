"""viterbi-k7: the paper's own workload as a service config (§IX-A):
code (2,1,7), polynomials (171,133) octal, soft decision, radix-4 fused
ACS, frame tiling f=64 / v=32; and the registry of serving cells the
benchmarks resolve by name.

The same fields, defaults, configs and cells as the reference's
``configs/viterbi_k7.py``, with one difference: ``KERNEL_CONFIGS`` is
empty.  The reference's entries are the output of its TPU autotune
sweep (``benchmarks/autotune.py``, not ported), tiles and dtypes tuned
for a TPU's VMEM, and none of them carries over to the card.  So
``apply_kernel_config`` is the identity on every cell, and
``config_for_cell(c)`` equals ``config_for_standard(VITERBI_CELLS[c].code)``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.trellis import CODE_K7_CCSDS, CodeSpec
from repro_torch.core.viterbi import AcsPrecision, TiledDecoderConfig

__all__ = [
    "ViterbiConfig",
    "CONFIG",
    "CONFIG_OPTIMIZED",
    "config_for_standard",
    "ViterbiCell",
    "VITERBI_CELLS",
    "KernelConfig",
    "KERNEL_CONFIGS",
    "kernel_config_for",
    "apply_kernel_config",
    "config_for_cell",
    "input_specs",
    "smoke_config",
]


@dataclasses.dataclass(frozen=True)
class ViterbiConfig:
    name: str = "viterbi-k7"
    family: str = "viterbi"
    spec: CodeSpec = CODE_K7_CCSDS
    # registry standard this config serves (repro_torch.codes.registry);
    # the decoder front door inherits its puncture pattern and termination
    code: str = "ccsds-k7"
    rho: int = 2
    frame_len: int = 64
    overlap: int = 32
    # serving shapes: a batch of independent LLR streams
    stream_len: int = 1 << 16  # stages per stream
    batch_streams: int = 512
    # precision and layout knobs (paper Table I analogues)
    channel_bf16: bool = False  # bf16 LLR blocks and matmul inputs
    pack_survivors: bool = False  # 16 x 2-bit survivors per int32
    renorm: bool = True  # per-step path-metric renormalization
    split_dot: bool = False  # bf16 branch metrics, f32 metric routing
    # one-pass kernel geometry; None = library defaults
    time_tile: Optional[int] = None
    block_frames: Optional[int] = None
    # time-parallel decode: None = auto-select by shape; transfer_tile is
    # the matrix-scan tile
    time_parallel: Optional[bool] = None
    transfer_tile: Optional[int] = None

    @property
    def tiled(self) -> TiledDecoderConfig:
        return TiledDecoderConfig(
            frame_len=self.frame_len, overlap=self.overlap, rho=self.rho
        )

    @property
    def precision(self) -> AcsPrecision:
        if self.channel_bf16:
            return AcsPrecision(
                matmul_dtype=torch.bfloat16,
                channel_dtype=torch.bfloat16,
                renorm=self.renorm,
                split_dot=self.split_dot,
            )
        return AcsPrecision(renorm=self.renorm, split_dot=self.split_dot)


CONFIG = ViterbiConfig()  # the paper-faithful baseline (Table I single precision)

# the optimized service config: bf16 channel, packed survivors, f=128
# frames
CONFIG_OPTIMIZED = ViterbiConfig(
    name="viterbi-k7-opt",
    frame_len=128,
    channel_bf16=True,
    pack_survivors=True,
)


def config_for_standard(name: str, **overrides) -> ViterbiConfig:
    """A ViterbiConfig serving one registry standard: spec, puncture and
    termination all follow the registry entry."""
    from repro_torch.codes.registry import get_code

    code = get_code(name)
    kw = dict(name=f"viterbi-{name}", spec=code.spec, code=name)
    kw.update(overrides)
    return ViterbiConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ViterbiCell:
    name: str
    stream_len: int
    batch_streams: int
    kind: str = "decode"
    code: str = "ccsds-k7"  # registry standard the cell serves


# the paper's workload cells: short LTE-like blocks up to DVB-like
# streams, plus one cell per deployed standard
VITERBI_CELLS = {
    "decode_64k": ViterbiCell("decode_64k", 1 << 16, 512),
    "decode_1m": ViterbiCell("decode_1m", 1 << 20, 32),
    # punctured streams: stream_len is the KEPT (serial) LLR count
    "decode_64k_wifi_r34": ViterbiCell(
        "decode_64k_wifi_r34", 1 << 16, 512, code="wifi-11a-r34"
    ),
    "decode_64k_dvb_r78": ViterbiCell(
        "decode_64k_dvb_r78", 1 << 16, 512, code="dvb-s-r78"
    ),
    # tail-biting control blocks are short; the batch is deep
    "decode_tbcc_blocks": ViterbiCell(
        "decode_tbcc_blocks", 128, 8192, code="lte-tbcc"
    ),
    "decode_gsm_bursts": ViterbiCell(
        "decode_gsm_bursts", 456, 4096, code="gsm-cs1"
    ),
}


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Kernel geometry for a serving cell: the one-pass kernel's frames a
    block and time tile, the packed ring, the matmul dtype, and the
    time-parallel transfer tile.  ``apply_kernel_config`` threads it
    into a ViterbiConfig so ``ViterbiDecoder.from_config`` picks it up."""

    block_frames: int = 256
    time_tile: int = 32
    pack_survivors: bool = True
    matmul_dtype: str = "f32"  # "f32" | "bf16"
    transfer_tile: Optional[int] = None  # None = shape-derived default

    def overrides(self) -> dict:
        return dict(
            block_frames=self.block_frames,
            time_tile=self.time_tile,
            pack_survivors=self.pack_survivors,
            channel_bf16=self.matmul_dtype == "bf16",
            transfer_tile=self.transfer_tile,
        )


# Tuned geometry per cell.  Empty: the reference's entries are TPU
# autotune output and no sweep has been run on the card.
KERNEL_CONFIGS: dict = {}


def kernel_config_for(cell_name: str) -> KernelConfig:
    """A cell's tuned geometry (the library default otherwise)."""
    return KERNEL_CONFIGS.get(cell_name, KernelConfig())


def apply_kernel_config(cfg: ViterbiConfig, cell_name: str) -> ViterbiConfig:
    """``cfg`` with the cell's tuned kernel geometry applied (``cfg``
    itself for a cell without an entry, which is every cell)."""
    if cell_name not in KERNEL_CONFIGS:
        return cfg
    return dataclasses.replace(cfg, **kernel_config_for(cell_name).overrides())


def config_for_cell(cell_name: str, **overrides) -> ViterbiConfig:
    """Cell name -> ready ViterbiConfig: the cell's registry standard
    plus its tuned kernel geometry (none yet).  The serve launcher
    resolves by code name (``config_for_standard``), not by cell."""
    cell = VITERBI_CELLS[cell_name]
    cfg = apply_kernel_config(config_for_standard(cell.code), cell_name)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def input_specs(cfg: ViterbiConfig, cell: ViterbiCell):
    """Serving-shape inputs of a cell, as {"llrs": (shape, dtype)}.
    Punctured cells take the serial kept-LLR stream (batch, Lp);
    unpunctured cells the shaped (batch, n, beta) LLRs."""
    from repro_torch.codes.registry import get_code

    code = get_code(cell.code)
    if code.puncture is not None:
        shape = (cell.batch_streams, cell.stream_len)
    else:
        shape = (cell.batch_streams, cell.stream_len, code.spec.beta)
    return {"llrs": (shape, torch.float32)}


def smoke_config() -> ViterbiConfig:
    return ViterbiConfig(
        name="viterbi-k7-smoke", stream_len=512, batch_streams=4
    )
