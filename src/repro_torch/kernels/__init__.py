"""Hand-written CUDA kernels for Hopper, one per Pallas TPU kernel of the
reference, K4 for the scans' compose and K6 for the BCJR's within-tile
sweeps, each with its plain PyTorch version.

Layout: ``csrc/`` (CUDA C++ sources, built with ``nvcc`` at first use),
``<name>.py`` (build, binding and the wrapper that launches the kernel),
``ops.py`` (the wrappers ``core`` calls), ``ref.py`` (the plain
versions).  Nothing is built or loaded at import.
"""
from .ops import (  # noqa: F401
    viterbi_decode_fused,
    viterbi_forward,
    viterbi_transfer_matrices,
)
from .viterbi_acs import (  # noqa: F401
    acs_decode_fused,
    acs_forward,
    bcjr_sweep,
    semiring_compose,
    transfer_matrix,
)
