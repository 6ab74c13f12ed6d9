"""decoded_Mbps: the information bits that the window's calls returned,
over the window's whole length (host clock, from the first call with the
inputs resident on the card to the synchronise after the last)."""


def read(ctx):
    if ctx.calls == 0 or ctx.window_s <= 0:
        return None
    return ctx.info_bits / ctx.window_s / 1e6
