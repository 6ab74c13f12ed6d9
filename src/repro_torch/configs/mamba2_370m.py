"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    d_ff=0,  # no MLP blocks: pure mamba stack
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m-smoke", family="ssm", n_layers=2, d_model=128,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=512, ssm_state=32,
        ssm_expand=2, ssm_head_dim=32, ssm_chunk=32,
    )
