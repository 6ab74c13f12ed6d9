"""Core library: the paper's tensor-formulated Viterbi decoder (batch
decode, sequential or time-parallel, of zero-terminated and tail-biting
frames; tiled and chunked streaming; soft output: BCJR and list-Viterbi;
punctured input through every entry point; the BER harness in
``core/ber.py``)."""
from .trellis import (  # noqa: F401
    AcsTables,
    CodeSpec,
    CODE_K7_CCSDS,
    build_acs_tables,
    build_transitions,
    tables_from_numpy,
)
from .viterbi import (  # noqa: F401
    AcsPrecision,
    TiledDecoderConfig,
    decode_frames,
    forward_fused,
    tiled_decode_stream,
    traceback,
    traceback_with_state,
)
from .timeparallel import (  # noqa: F401
    decode_time_parallel,
    prefix_entry_metrics,
    timeparallel_forward,
    transfer_matrices,
    tropical_matmul,
)
from .decoder import (  # noqa: F401
    DEFAULT_DECISION_DEPTH,
    StreamState,
    ViterbiDecoder,
)
from .encoder import (  # noqa: F401
    conv_encode,
    conv_encode_torch,
    tail_bite_state,
    tail_flush,
)
from .viterbi_ref import viterbi_decode_ref  # noqa: F401
