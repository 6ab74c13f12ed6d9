"""kernels_per_call: the device kernels of the traced calls, over their
number (copies and fills are not kernels)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.calls == 0:
        return None
    return ctx.trace.kernels / ctx.trace.calls
