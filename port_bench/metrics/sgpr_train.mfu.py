"""The SGPR training step's share of the card's peak: steps x the
configuration's flop a step (``flop``) over the window's length x 989
TFLOP/s, outside the profiled slice (``readers.untraced``)."""

from port_bench.harness import PEAK_FLOPS
from port_bench.readers import untraced


def flop(config, n):
    """One step's flop at n points, M inducing points on D inputs: 3 x (the
    forward's work, the backward taken as twice it), the forward being
    M^2 N for the TRSM L^-1 Kuf, M^2 N for the symmetric A A^T, 2 M^3 / 3
    for the two M x M factors and 3 M N D for the cross Gram's distances."""
    m, d = config["num_inducing"], config["input_dim"]
    return 3 * (m * m * n + m * m * n + 2 * m**3 / 3 + 3 * m * n * d)


def read(ctx):
    steps, _, seconds = untraced(ctx)
    if not steps:
        return None
    return 100 * steps * flop(ctx["config"], ctx["stats"]["n"]) / (seconds * PEAK_FLOPS)
