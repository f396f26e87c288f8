"""Milliseconds a step of device idle ended by an operation launched inside
either VJP of the GPR objective, ``gfs.chol_solve_logdet.bwd`` or
``gfs.gram_operand.bwd`` (or a span nested in one), on the launching
thread: the card waiting on the backward's host work (``spans.idle_ms``)."""

from port_bench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, ("gfs.chol_solve_logdet.bwd", "gfs.gram_operand.bwd"))
