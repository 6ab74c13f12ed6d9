"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    experts_per_token=2,
    moe_dense_residual=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="arctic-480b-smoke", family="moe", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=512, n_experts=8,
        experts_per_token=2, moe_dense_residual=True, capacity_factor=8.0,
        dense_attn_max=256, attn_chunk=64,
    )
