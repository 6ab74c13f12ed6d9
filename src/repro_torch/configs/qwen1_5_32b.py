"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,  # GQA kv=40 (full MHA)
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-32b-smoke", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=352, vocab_size=512, qkv_bias=True,
        dense_attn_max=256, attn_chunk=64,
    )
