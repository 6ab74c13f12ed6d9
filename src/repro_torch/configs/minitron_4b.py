"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="minitron-4b-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=288, vocab_size=512,
        dense_attn_max=256, attn_chunk=64,
    )
