"""wava_ms: how long WAVA's circulations (the ``wava`` stage: a K1 pass
and a traceback each) hold the card's stream in a traced call, in ms.
The traceback inside launches a step at a time; at the cell's 524,288
blocks the card stays busy through it."""
from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "wava")
