"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x7b-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512, n_experts=4,
        experts_per_token=2, sliding_window=128, capacity_factor=8.0,
        dense_attn_max=256, attn_chunk=64,
    )
