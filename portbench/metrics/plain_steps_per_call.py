"""plain_steps_per_call: the iterations of the program's plain per-step
loops (the stages' ``steps``: traceback, alpha, beta, the plain forward
and the list loops) in a traced call."""
from portbench.stages import per_call


def read(ctx):
    return per_call(ctx, "steps")
