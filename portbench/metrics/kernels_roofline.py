"""kernels_roofline: the share of the kernels' time that the decode's
least time (``work.Work.least_time_s``, from the cell's shapes and code)
would take: least time x traced calls over the summed device time of
every kernel the traced calls ran, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.kernel_s <= 0:
        return None
    return 100.0 * ctx.work.least_time_s() * ctx.trace.calls / ctx.trace.kernel_s
