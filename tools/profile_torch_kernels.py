#!/usr/bin/env python3
"""Device time of the port's kernels, each run alone on one NVIDIA GPU, for
one checkout of the repository; the tool to compare two commits on one card.

    python3 tools/profile_torch_kernels.py [ROOT] [--gram]

ROOT is the checkout whose gpflow_slim_tpu_torch (and kernels, built into
its own build/) is measured; by default the one this file is in. The timing
methods are this file's chip_smoke.py's. ``--gram`` measures the cross
Gram alone. It prints:

- for Np = 64 .. 10048 (RBF operands of lengthscale 0.1 and unit noise)
  the CUDA-event time of ``cholesky_cuda`` and the mean device time and
  count of each of its kernels (diag, panel, in-panel update, trailing
  update) by torch.profiler: at Np <= 256 there is no trailing update, so
  the chain's launches run alone;
- the thin TRSM (P = 1, upper through the transposed view) at N = 640,
  2560, 10000 against ``torch.linalg.solve_triangular``, with its time per
  64-row block row;
- the batched TRSM at (P, M, K) = (1, 256, 256), (16, 256, 256) and
  (1, 1024, 1024) against ``torch.linalg.solve_triangular``, and the Gram
  operand (RBF, N = 10000, D = 1, padded to 10048);
- the cross Gram (RBF, D = 1) at the serving shape 10000 x 2048, at the
  SVGP shapes 256 x 256 and 256 x 1024, and at 10000 x 2047 (a ragged M),
  with its write bound.

The TRSMs and the operand are timed by the three methods of chip_smoke.py's
kernels line (``cuda_ms``, medians of 5): one call through the wrapper
between two CUDA events, runs of 20 back-to-back calls (a call's share),
and one call queued behind a spin kernel (the device's time alone); then
the device time of each kernel a launch by torch.profiler, with its
launches a call (fewer than the function makes where the profiler lost
events).

To compare a parent with a change, unpack the parent with git archive into
a directory that .gitignore lists (under build/) and run parent, change,
change, parent, one process each. The card's name and power limit come
first. Needs a CUDA device.
"""

import math
import os
import re
import statistics
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def per_kernel_us(fn, setup=lambda: ()):
    """{kernel name: (mean device us, launches per call)} over REPS calls;
    every setup runs before the profiler starts."""
    args = [setup() for _ in range(cs.REPS + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for a in args[1:]:
            fn(*a)
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            t = by.setdefault(m.group(1) if m else e.name[:30], [0.0, 0])
            t[0] += e.time_range.end - e.time_range.start
            t[1] += 1
    return {k: (round(t / n, 1), n / cs.REPS) for k, (t, n) in by.items()}


def three(fn):
    """(its times by the kernels line's three methods and the profiler's
    per-kernel times, as text; the per-kernel times) of a function with no
    set-up."""
    one = statistics.median(cs.cuda_ms(torch, fn))
    run = statistics.median(cs.cuda_ms(torch, fn, run=cs.RUN))
    queued = statistics.median(cs.cuda_ms(torch, fn, queued=True))
    dev = per_kernel_us(fn)
    return (f"one call {one:.4f} ms, runs of {cs.RUN} {run:.4f} ms, queued {queued:.4f} ms; "
            f"profiler (us, launches) {dev}"), dev


def cross_gram(tag, gram, g, one, dev):
    for n, m in ((10000, 2048), (256, 256), (256, 1024), (10000, 2047)):
        xs = torch.rand(n, 1, generator=g, device=dev) / 0.1
        x2 = torch.rand(m, 1, generator=g, device=dev) / 0.1
        print(f"{tag} cross gram rbf {n} x {m} (write bound {n * m * 4 / cs.HBM_BYTES * 1e3:.4f} ms): "
              f"{three(lambda: gram.gram_cuda('rbf', xs, x2, one))[0]}", flush=True)


def main():
    args = [a for a in sys.argv[1:] if a != "--gram"]
    root = os.path.abspath(args[0]) if args else REPO
    if not torch.cuda.is_available():
        print("profile_torch_kernels: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    from gpflow_slim_tpu_torch.ops import cholesky, gram, trsm

    tag = os.path.basename(root)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    one = torch.tensor(1.0, device=dev)
    print(cs.card_line())
    print(f"{tag}: kernels of {os.path.dirname(gram.__file__)}", flush=True)
    if "--gram" in sys.argv:
        cross_gram(tag, gram, g, one, dev)
        return 0
    for n in (64, 256, 1024, 4096, 10048):
        xs = torch.rand(n, 1, generator=g, device=dev) / 0.1
        Kp = gram.gram_chol_operand_cuda("rbf", xs, one, one, n)
        fresh = lambda: (Kp.clone(),)  # noqa: E731
        ms = statistics.median(cs.cuda_ms(torch, cholesky.cholesky_cuda, fresh))
        kernels = {k: v for k, v in per_kernel_us(cholesky.cholesky_cuda, fresh).items() if "chol" in k}
        print(f"{tag} Np={n}: cholesky_cuda {ms:.3f} ms; per kernel (us, launches): {kernels}", flush=True)
    for n in (640, 2560, 10000):
        L = torch.randn(n, n, generator=g, device=dev).tril_() * 0.01 + 2 * torch.eye(n, device=dev)
        b = torch.randn(n, 1, generator=g, device=dev)
        text, dev_us = three(lambda: trsm.trsm_cuda(L.T, b, False))
        print(f"{tag} thin TRSM N={n}: {text} ({dev_us.get('trsm_thin_kernel', (math.nan,))[0] / (n / 64):.2f} us per block "
              f"row); torch.linalg.solve_triangular "
              f"{three(lambda: torch.linalg.solve_triangular(L.T, b, upper=True))[0]}", flush=True)
    del L
    for P, M, K in ((1, 256, 256), (16, 256, 256), (1, 1024, 1024)):
        T = torch.randn(P, M, M, generator=g, device=dev).tril_() + M * torch.eye(M, device=dev)
        B = torch.randn(P, M, K, generator=g, device=dev)
        print(f"{tag} batched TRSM ({P}, {M}, {K}): {three(lambda: trsm.batched_trsm_cuda(T, B, True))[0]}; "
              f"torch.linalg.solve_triangular "
              f"{three(lambda: torch.linalg.solve_triangular(T, B, upper=False))[0]}", flush=True)
    xs = torch.rand(10000, 1, generator=g, device=dev) / 0.1
    print(f"{tag} gram operand rbf N=10000 pad_to=10048 (write bound "
          f"{cs.tri_bytes(10048) / cs.HBM_BYTES * 1e3:.4f} ms): "
          f"{three(lambda: gram.gram_chol_operand_cuda('rbf', xs, one, one, 10048))[0]}", flush=True)
    cross_gram(tag, gram, g, one, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
