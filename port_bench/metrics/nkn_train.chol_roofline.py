"""The Cholesky kernels' share of their roofline in the NKN fit, the factor
it shares with the RBF fit: max(N^3/3 flop at the peak rate, K's lower
triangle read once and L's written once at the memory rate) over the device
time of csrc/chol_solve.cu's kernels per evaluation in the profiled slice
(``readers.chol_roofline``)."""

from port_bench.readers import chol_roofline


def read(ctx):
    return chol_roofline(ctx)
