"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="smollm-135m-smoke", family="dense", n_layers=2, d_model=96,
        n_heads=3, n_kv_heads=1, d_ff=256, vocab_size=512,
        dense_attn_max=256, attn_chunk=64,
    )
