"""setup_s: from the start of the benchmark's process to the first timed
call: imports, the CUDA context, the program's kernels built or loaded,
the inputs drawn on the card and two warm-up calls."""


def read(ctx):
    return ctx.setup_s
