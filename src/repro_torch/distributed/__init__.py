"""Multi-device decode: the frame-, stream- and time-sharded decodes over
a ``FrameMesh`` and the mesh helpers the serving engine routes and fails
over with (``distributed.decoder``).  The LM testbed's sharding rules
and sharded tensors (``distributed.sharding``), its sharded train,
prefill and decode steps on a ``launch.mesh.Mesh``
(``distributed.spmd``) and the GPipe schedule
(``distributed.pipeline``) are modules of their own."""
from .decoder import (  # noqa: F401
    FrameMesh,
    engine_dispatch_ready,
    frame_mesh,
    replan_mesh,
    sharded_decode_frames,
    sharded_decode_streams,
    sharded_decode_time_parallel,
)
