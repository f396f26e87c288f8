"""100 (1 - union of device activity / wall) over the NKN fit's profiled
slice (``readers.idle_share``)."""

from port_bench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
