"""glm4-9b [dense] — RoPE, GQA kv=2 [hf:THUDM/glm-4-9b; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="glm4-9b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=8, n_kv_heads=2, d_ff=352, vocab_size=512,
        dense_attn_max=256, attn_chunk=64,
    )
