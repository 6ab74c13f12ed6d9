"""Optimisers of the LM testbed: ``adamw`` (AdamW, clipping, the cosine
schedule) and ``compress`` (EF-int8 data-parallel gradient reduction),
ports of the reference's ``optim/`` modules."""
from .adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from .compress import (  # noqa: F401
    compressed_psum,
    dequantize_int8,
    init_residuals,
    make_dp_train_step_compressed,
    quantize_int8,
)
