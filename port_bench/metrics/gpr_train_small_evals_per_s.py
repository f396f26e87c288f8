"""Every step completed in the window over the window's length, from its
first step's start to the end of the device's work (host clock)."""

from port_bench.readers import rate


def read(ctx):
    return rate(ctx)
