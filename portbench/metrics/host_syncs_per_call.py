"""host_syncs_per_call: the program's sites that block the host until the
card's stream drains (the stages' ``host_syncs``: host reads and copies
from pageable host memory) in a traced call."""
from portbench.stages import per_call


def read(ctx):
    return per_call(ctx, "host_syncs")
