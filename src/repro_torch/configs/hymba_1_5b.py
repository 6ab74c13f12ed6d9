"""hymba-1.5b [hybrid] — parallel attention + mamba heads
[arXiv:2411.13676].  Uniform SWA on the attention branch (the published
model mixes global/local layers; see DESIGN.md §Arch-applicability)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    sliding_window=1024,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=352, vocab_size=512, ssm_state=16,
        ssm_expand=2, ssm_head_dim=32, sliding_window=64,
        dense_attn_max=256, attn_chunk=64, ssm_chunk=32,
    )
