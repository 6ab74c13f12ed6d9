"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].
Backbone only: the InternViT frontend is a STUB providing precomputed patch
embeddings via input_specs()."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    prefix_len=256,  # ViT patch embeddings (stub)
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-2b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_ff=352, vocab_size=515,  # odd, pads to 768
        frontend="vision", prefix_len=16, dense_attn_max=256, attn_chunk=64,
    )
