"""Multi-device decode: the frame-, stream- and time-sharded decodes over
a ``FrameMesh`` and the mesh helpers the serving engine routes and fails
over with (``distributed.decoder``)."""
from .decoder import (  # noqa: F401
    FrameMesh,
    engine_dispatch_ready,
    frame_mesh,
    replan_mesh,
    sharded_decode_frames,
    sharded_decode_streams,
    sharded_decode_time_parallel,
)
