"""100 (1 - union of device activity / wall) over the profiled slice."""

from port_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
