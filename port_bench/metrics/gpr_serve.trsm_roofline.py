"""The TRSM kernels' share of their roofline over the profiled slice: the
sum over its requests of max(N^2 P flop at the peak rate, L's lower
triangle and the N x P right side read and written once at the memory
rate) over the device time of csrc/trsm.cu's kernels."""

from port_bench.readers import bound_s, device_s

KERNELS = ("trsm_thin_kernel", "trsm_group_kernel", "trsm_update_kernel")


def read(ctx):
    t, n = ctx["trace"], ctx["stats"]["n"]
    spent = device_s(ctx, KERNELS)
    if spent is None or not t["sizes"]:
        return None
    tri = n * (n + 1) // 2 * 4
    return 100 * sum(bound_s(n * n * p, tri + 2 * n * p * 4) for p in t["sizes"]) / spent
