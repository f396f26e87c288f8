"""Serving's share of the card's peak: the sum over the window's requests
of N^2 P + 4 N P + 3 N P D flop (the solve against L, the cross Gram, the
mean and the variance) over the window's length x 989 TFLOP/s, outside the
profiled slice."""

from port_bench.harness import PEAK_FLOPS
from port_bench.readers import untraced


def read(ctx):
    _, sizes, seconds = untraced(ctx)
    if not sizes:
        return None
    n, d = ctx["stats"]["n"], ctx["stats"]["input_dim"]
    return 100 * sum(n * n * p + 4 * n * p + 3 * n * p * d for p in sizes) / (seconds * PEAK_FLOPS)
