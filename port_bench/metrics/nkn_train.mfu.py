"""The NKN GPR training step's share of the card's peak: evaluations x (N^3
+ 2 N^2) flop over the window's length x 989 TFLOP/s, outside the profiled
slice (``readers.fit_mfu``): the factor's work, the NKN's own is left out."""

from port_bench.readers import fit_mfu


def read(ctx):
    return fit_mfu(ctx)
