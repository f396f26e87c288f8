"""Milliseconds a step of the SGPR fit from the end of the forward to the
start of the optimizer step (the cross Gram's VJP, the wide TRSM's, the
M x N x M products' and the two factors'), between two CUDA events the
benchmark records there, summed over the traced window's steps and divided
by them (``readers.backward_ms``)."""

from port_bench.readers import backward_ms


def read(ctx):
    return backward_ms(ctx)
