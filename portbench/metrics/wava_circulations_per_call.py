"""wava_circulations_per_call: the passes WAVA made over the circular
trellis (the ``wava`` stage's ``circulations``) in a traced call."""
from portbench.stages import per_call


def read(ctx):
    return per_call(ctx, "circulations", ["wava"])
