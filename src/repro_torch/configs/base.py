"""Architecture configs (``--arch <id>``) and input-shape cells of the LM
testbed, a port of the reference's ``configs/base.py``.

Every architecture has one module in this package with an ``ArchConfig``
of the published numbers and a reduced ``smoke_config()`` of the same
family.  The fields, defaults, derived properties and parameter counts
are the reference's number for number.  The TPU-only performance flags
(``decode_ring_write``, ``decode_deferred_write``, ``zero3_gather_at_use``,
``remat``, ``seq_parallel``, ``causal_skip``) stay as data: the first two
and ``causal_skip`` choose between code paths that the port keeps; the
others belong to the sharding and training slices.

``input_specs`` returns ``(shape, torch.dtype)`` tuples, as
``configs/viterbi_k7.py::input_specs`` does; the reference returns
``jax.ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = [
    "ArchConfig",
    "ShapeCell",
    "SHAPE_CELLS",
    "cell_applicable",
    "input_specs",
    "pad_vocab",
    "torch_dtype",
]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
}


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``activation_dtype``, ``param_dtype``,
    ``kv_cache_dtype``) as a ``torch.dtype``."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r}; known: {sorted(_DTYPES)}"
        ) from None


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int  # 0 for attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_dense_residual: bool = False  # Arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    # SSM (Mamba-2 SSD)
    ssm_state: int = 0  # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # P
    ssm_groups: int = 1  # G
    ssm_conv_width: int = 4
    # attention windowing
    sliding_window: int = 0  # 0 = full attention
    # modality frontend stub: prefix embeddings prepended to the sequence
    frontend: Optional[str] = None  # None | "audio" | "vision"
    prefix_len: int = 0
    # numerics / training
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # "int8": quantized KV cache with
    # per-(token, head) scales
    decode_ring_write: bool = True  # masked ring write of the decode
    # cache; False = an indexed slot copy (the reference's
    # dynamic_update_slice)
    decode_deferred_write: bool = True  # the layer loop never writes the
    # cache: the current token is a separate softmax term and the stacked
    # cache is written once after the loop
    zero3_gather_at_use: bool = False  # a sharding constraint of the
    # reference (a refuted TPU experiment); data only here
    remat: bool = True  # training slice
    seq_parallel: bool = True  # sharding slice
    attn_chunk: int = 512  # chunked attention block (long sequences)
    dense_attn_max: int = 2048  # use dense attention at/below this seq len
    causal_skip: bool = False  # visit only the causal chunk pairs
    ssm_chunk: int = 128

    # -- derived --
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + stacked layers + head)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.padded_vocab
        hd = self.head_dim_
        p = V * D * 2  # embed + untied head
        per_layer = 0
        if not self.attn_free:
            qkv = D * hd * (self.n_heads + 2 * self.n_kv_heads)
            per_layer += qkv + self.n_heads * hd * D
            if self.qkv_bias:
                per_layer += hd * (self.n_heads + 2 * self.n_kv_heads)
        if self.family in ("ssm", "hybrid"):
            di, G, N, H = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            in_proj = D * (2 * di + 2 * G * N + H)
            conv = self.ssm_conv_width * (di + 2 * G * N)
            per_layer += in_proj + conv + di * D + 2 * H + di
        if self.n_experts:
            per_layer += D * self.n_experts + self.n_experts * 3 * D * F
            if self.moe_dense_residual:
                per_layer += 3 * D * F
        elif F:
            per_layer += 3 * D * F
        per_layer += 2 * D  # norms
        return p + L * per_layer + D

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        full_moe = L * self.n_experts * 3 * D * F
        active_moe = L * self.experts_per_token * 3 * D * F
        return self.n_params() - full_moe + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPE_CELLS = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, cell: ShapeCell) -> bool:
    """long_500k needs sub-quadratic attention."""
    if cell.name == "long_500k":
        return cfg.sub_quadratic
    return True


def input_specs(cfg: ArchConfig, cell: ShapeCell):
    """Every model input of this cell as {name: (shape, torch.dtype)}."""
    i32 = torch.int32
    B, S = cell.global_batch, cell.seq_len
    S_tok = S - cfg.prefix_len
    specs = {}
    if cell.kind == "train":
        specs["tokens"] = ((B, S_tok), i32)
        specs["labels"] = ((B, S_tok), i32)
    elif cell.kind == "prefill":
        specs["tokens"] = ((B, S_tok), i32)
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = ((B, 1), i32)
    if cfg.prefix_len and cell.kind != "decode":
        specs["prefix_embeds"] = ((B, cfg.prefix_len, cfg.d_model), torch.bfloat16)
    return specs
