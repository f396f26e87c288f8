#!/usr/bin/env python3
"""Device time of each launch of the factor-only Cholesky and of the thin
TRSM, run alone on one NVIDIA GPU.

    python3 tools/profile_torch_kernels.py

For Np = 64 .. 10048 (RBF operands of lengthscale 0.1 and unit noise) it
prints the CUDA-event time of ``cholesky_cuda`` and, from torch.profiler,
the mean device time and count of each of its kernels (diag, panel,
in-panel update, trailing update): at Np <= 256 there is no trailing
update, so the chain's launches run alone. Then the thin TRSM (P = 1,
upper through the transposed view) at N = 640, 2560, 10000 against
``torch.linalg.solve_triangular``, with its time per 64-row block row. The
card's name and power limit come first. Needs a CUDA device.
"""

import os
import re
import statistics
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import card_line  # noqa: E402
from gpflow_slim_tpu_torch.ops import cholesky, gram, trsm  # noqa: E402

REPS = 5


def per_kernel_us(fn):
    """{kernel name: (mean device us, launches per call)} over REPS calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            t = by.setdefault(m.group(1) if m else e.name[:30], [0.0, 0])
            t[0] += e.time_range.end - e.time_range.start
            t[1] += 1
    return {k: (round(t / n, 1), n // REPS) for k, (t, n) in by.items()}


def event_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line())
    for n in (64, 256, 1024, 4096, 10048):
        xs = torch.rand(n, 1, device=dev) / 0.1
        Kp = gram.gram_chol_operand_cuda("rbf", xs, 1.0, 1.0, n)

        def factor():
            cholesky.cholesky_cuda(Kp.clone())

        kernels = {k: v for k, v in per_kernel_us(factor).items() if "chol" in k}
        print(f"Np={n}: cholesky_cuda {event_ms(factor):.3f} ms; per kernel (us, launches): {kernels}",
              flush=True)
    for n in (640, 2560, 10000):
        L = torch.randn(n, n, device=dev).tril_() * 0.01 + 2 * torch.eye(n, device=dev)
        b = torch.randn(n, 1, device=dev)
        us = per_kernel_us(lambda: trsm.trsm_cuda(L.T, b, False))["trsm_thin_kernel"][0]
        lib = event_ms(lambda: torch.linalg.solve_triangular(L.T, b, upper=True))
        print(f"thin TRSM N={n}: kernel {us / 1e3:.3f} ms ({us / (n / 64):.2f} us per block row); "
              f"torch.linalg.solve_triangular {lib:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
