"""Milliseconds a step of the union of device operations launched inside
the fused Cholesky's backward, ``gfs.chol_solve_logdet.bwd`` (f64 K^-1 and
the solves), or a span nested in it, on the launching thread
(``spans.launched_ms``)."""

from port_bench.spans import launched_ms


def read(ctx):
    return launched_ms(ctx, ("gfs.chol_solve_logdet.bwd",))
