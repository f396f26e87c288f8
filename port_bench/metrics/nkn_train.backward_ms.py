"""Milliseconds a step of the NKN fit from the end of the forward to the
start of the optimizer step (the factor's f64 VJP and the NKN operand's),
between two CUDA events the benchmark records there, summed over the traced
window's steps and divided by them (``readers.backward_ms``)."""

from port_bench.readers import backward_ms


def read(ctx):
    return backward_ms(ctx)
