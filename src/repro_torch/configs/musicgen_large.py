"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].  Backbone only: the EnCodec/conditioning frontend is
a STUB whose input_specs() provide precomputed frame embeddings."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="dense",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    prefix_len=64,  # conditioning frame embeddings (stub)
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=352, vocab_size=512,
        frontend="audio", prefix_len=8, dense_attn_max=256, attn_chunk=64,
    )
