"""traceback_ms: how long the plain traceback stage holds the card's
stream in a traced call (CUDA events at its entry and exit), in ms.
Host-paced: a launch a step, so the stream waits on the profiled host
inside the stage; it tells apart only changes of several times."""
from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "traceback")
