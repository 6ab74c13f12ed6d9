"""decode_p95_ms: the 95th percentile over every call of the window of
the time from the call being due (closed loop: when the previous call's
output was ready) to its output being ready on the card (synchronised);
``statistics.quantiles`` at n = 100, its 95th cut point."""
import statistics


def read(ctx):
    if len(ctx.latencies_s) < 2:
        return None
    return statistics.quantiles(ctx.latencies_s, n=100)[94] * 1e3
