"""window_gather_ms: how long the tiled path's window gather (the pad,
the index and the copy into windows) holds the card's stream in a traced
call, in ms.  Host-paced: its launches follow the front door's host
read, so the stream waits on the profiled host inside the stage; it
tells apart only large changes."""
from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "window_gather")
