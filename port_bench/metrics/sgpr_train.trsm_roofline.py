"""The TRSM kernels' share of their roofline in the SGPR fit: the sum over
a step's triangular solves of max(M^2 P flop at the peak rate, the
triangle's and the M x P right side's float32 bytes read and written once
at the memory rate) over the device time of csrc/trsm.cu's kernels a step
in the profiled slice. The solves are the configuration's (``work``),
whatever implements them."""

from port_bench.readers import bound_s, device_s

KERNELS = ("trsm_thin_kernel", "trsm_group_kernel", "trsm_update_kernel")


def work(config, n):
    """(flop, bytes) of each triangular solve of one step at n points,
    against an M-row factor: L^-1 Kuf (P = n) and LB^-1 (A err) (P = 1),
    each once forward and once more in its VJP on the transposed factor;
    Murray's Cholesky VJP, two solves of P = M for each of the two
    factors, chol(Kuu) and chol(B)."""
    m = config["num_inducing"]
    tri = m * (m + 1) // 2
    widths = [n, n, 1, 1] + [m] * 4
    return [(m * m * p, (tri + 2 * m * p) * 4) for p in widths]


def read(ctx):
    t = ctx["trace"]
    spent = device_s(ctx, KERNELS)
    if spent is None or not t["units"]:
        return None
    return 100 * sum(bound_s(f, b) for f, b in work(ctx["config"], ctx["stats"]["n"])) / (spent / t["units"])
