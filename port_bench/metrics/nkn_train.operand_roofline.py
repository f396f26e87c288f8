"""The NKN operand's share of its roofline: max(its flop at the card's
float32 rate, its bytes at the memory rate) over the device time of its
kernels per evaluation in the profiled slice. The work is the
configuration's (``work``), whatever implements it. Its arithmetic is
float32 multiply-adds on the CUDA cores, a few at a time between an
entry's transcendentals, so it is priced at that rate, not at the
tensor cores' ``harness.PEAK_FLOPS``."""

from port_bench.harness import PEAK_BYTES
from port_bench.readers import device_s

NKN_KERNELS = ("nkn_operand_kernel", "nkn_vjp_kernel", "nkn_vjp_reduce_kernel")  # as nkn_train.operand_ms reads them
PAD = 64  # the operand is padded to a multiple of the fused Cholesky's 64
F32_FLOPS = 67e12  # H100 SXM float32 rate on the CUDA cores (chip_smoke.py's F32_FLOPS)


def work(config, n):
    """(flop, bytes) of one evaluation's operand and its VJP at n points.
    Bytes: the padded operand's lower triangle written once and the
    cotangent's lower triangle read once, float32. Flop, for each of the
    tri(n) entries: each Linear layer's in x out multiply-adds four times
    (the forward, the backward's forward again, the weights' gradient, the
    inputs' cotangent); each Product layer's in / step (step - 1)
    multiplies twice (the forward and again) and its in multiplies of the
    factors' cotangents; one multiply-add for each primitive parameter's
    gradient. A multiply-add is 2 flop."""
    mac = mul = 0
    for layer in config["layers"]:
        if layer["kind"] == "Linear":
            mac += 4 * layer["in"] * layer["out"]
        else:
            mul += 2 * (layer["in"] // layer["step"]) * (layer["step"] - 1) + layer["in"]
    mac += sum(len(p) - 2 for p in config["primitives"])  # every key but name and kind is a parameter
    tri_n = n * (n + 1) // 2
    n_pad = n + (-n) % PAD
    return tri_n * (2 * mac + mul), 4 * (n_pad * (n_pad + 1) // 2 + tri_n)


def read(ctx):
    t, n = ctx["trace"], ctx["stats"]["n"]
    spent = device_s(ctx, NKN_KERNELS)
    if spent is None or not t["units"]:
        return None
    flop, nbytes = work(ctx["config"], n)
    return 100 * max(flop / F32_FLOPS, nbytes / PEAK_BYTES) / (spent / t["units"])
