"""scans_ms: how long the compose scans (``associative_scan``) hold the
card's stream in a traced call, summed over both scans, in ms."""
from portbench.stages import device_ms


def read(ctx):
    return device_ms(ctx, "scan")
