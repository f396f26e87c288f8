"""Milliseconds a step of the union of device operations launched inside
the Gram operand's closed-form f64 VJP, ``gfs.gram_operand.bwd``, or a
span nested in it, on the launching thread (``spans.launched_ms``)."""

from port_bench.spans import launched_ms


def read(ctx):
    return launched_ms(ctx, ("gfs.gram_operand.bwd",))
