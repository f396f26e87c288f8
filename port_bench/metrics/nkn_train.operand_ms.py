"""Milliseconds a step of the union of the NKN operand's kernels on the
device, forward and backward (csrc/nkn_operand.cu: ``nkn_operand_kernel``,
``nkn_vjp_kernel``, ``nkn_vjp_reduce_kernel``), in the profiled slice
(``readers.device_s``); None where none ran."""

from port_bench.readers import device_s

NKN_KERNELS = ("nkn_operand_kernel", "nkn_vjp_kernel", "nkn_vjp_reduce_kernel")


def read(ctx):
    spent = device_s(ctx, NKN_KERNELS)
    if spent is None or not ctx["trace"]["units"]:
        return None
    return 1e3 * spent / ctx["trace"]["units"]
