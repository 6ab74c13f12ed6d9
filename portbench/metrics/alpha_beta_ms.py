"""alpha_beta_ms: how long the soft path's plain within-tile alpha and
beta scans hold the card's stream in a traced call, in ms.  Host-paced:
launches a step and pageable uploads, so the stream waits on the
profiled host inside the stages; it tells apart only large changes."""
from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "alpha", "beta")
