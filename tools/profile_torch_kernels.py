#!/usr/bin/env python3
"""Device time of the port's kernels, each run alone on one NVIDIA GPU, for
one checkout of the repository; the tool to compare two commits on one card.

    python3 tools/profile_torch_kernels.py [ROOT] [--gram | --chol | --lower | --kinv | --nkn]

ROOT is the checkout whose gpflow_slim_tpu_torch (and kernels, built into
its own build/) is measured; by default the one this file is in. The timing
methods are this file's chip_smoke.py's. ``--gram`` measures the cross
Gram alone, ``--chol`` both Cholesky modes alone at Np = 1024, 2048 and
10048, in the trailing-update arithmetic "hi" and, where the checkout has
it, the split modes "s3" and "s4", ``--lower`` the lower-tile Gram alone (``lower_gram``) and the VGP's
ELBO + gradient on the kernel route, ``--kinv`` the fused Cholesky's f64 VJP alone (``csl_vjp``), ``--nkn``
the NKN operand and its VJP alone (``nkn_operand``). It prints:

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
    return (f"one call {one:.4f} ms, runs of {cs.RUN} {run:.4f} ms, queued {queued:.4f} ms (host "
            f"{(one - queued) * 1e3:.2f} us a call: one call less queued); profiler (us, launches) {dev}"), dev


def cross_gram(tag, gram, g, one, dev):
    for n, m in ((10000, 2048), (256, 256), (256, 1024), (10000, 2047)):
        xs = torch.rand(n, 1, generator=g, device=dev) / 0.1
        x2 = torch.rand(m, 1, generator=g, device=dev) / 0.1
        print(f"{tag} cross gram rbf {n} x {m} (write bound {n * m * 4 / cs.HBM_BYTES * 1e3:.4f} ms): "
              f"{three(lambda: gram.gram_cuda('rbf', xs, x2, one))[0]}", flush=True)


def lower_gram(tag, gram, g, one, dev):
    """The lower-tile Gram (RBF) at the VGP's N = 2048, D = 2, serving's
    N = 10000, D = 1 and GPMC's N = 1000, D = 1, by the kernels line's three
    methods and the profiler, with the write bound; then chip_smoke.py's
    phase 4g VGP (Poisson, the 64 x 32 grid, untrained) ELBO + gradient on
    the kernel route, median of 2 x REPS by CUDA events."""
    for n, d in ((2048, 2), (10000, 1), (1000, 1)):
        xs = torch.rand(n, d, generator=g, device=dev) / 0.1
        print(f"{tag} lower-tile gram rbf N={n} D={d} (write bound {n * n * 4 / cs.HBM_BYTES * 1e3:.6f} ms): "
              f"{three(lambda: gram.gram_lower_cuda('rbf', xs, one))[0]}", flush=True)
    import gpflow_slim_tpu_torch as gft

    m = cs.vgp_model(gft, torch, "VGP", torch.float32, dev)

    def step():
        with gft.config.temp_settings(use_kernels=True, jitter=cs.VGP_JITTER):
            m.zero_grad(set_to_none=True)
            m.objective().backward()

    ms = statistics.median(cs.cuda_ms(torch, step, reps=2 * cs.REPS))
    print(f"{tag} VGP ELBO + gradient (N={cs.VGP_N}, kernel route): {ms:.4f} ms", flush=True)


def chol_modes(tag, cholesky, gram, g, one, dev):
    """Both Cholesky modes at Np = 1024, 2048 and 10048 (RBF operands of
    lengthscale 0.1 and unit noise; the fused mode with one right-hand
    side), in each trailing-update arithmetic the checkout has ("hi",
    and "s3" and "s4" where ``syrk`` exists): one call between CUDA events
    and one call queued behind a spin (device), medians of REPS, a fresh
    copy of the operand each call."""
    modes = ("hi", "s3", "s4") if hasattr(cholesky, "SYRK_MODES") else ("hi",)
    for n in (1024, 2048, 10048):
        xs = torch.rand(n, 1, generator=g, device=dev) / 0.1
        Kp = gram.gram_chol_operand_cuda("rbf", xs, one, one, n)
        D = torch.randn(n, 1, generator=g, device=dev)
        fresh = lambda: (Kp.clone(),)  # noqa: E731
        for syrk in modes:
            extra = () if syrk == "hi" else (syrk,)
            fac, fused = (lambda K: cholesky.cholesky_cuda(K, *extra)), (
                lambda K: cholesky.cholesky_solve_cuda(K, D, *extra))
            t = {name: (statistics.median(cs.cuda_ms(torch, fn, fresh)),
                        statistics.median(cs.cuda_ms(torch, fn, fresh, queued=True)))
                 for name, fn in (("cholesky_cuda", fac), ("cholesky_solve_cuda", fused))}
            print(f"{tag} Np={n} syrk={syrk}: " + ", ".join(
                f"{name} {ms:.4f} ms (device {dms:.4f})" for name, (ms, dms) in t.items()), flush=True)


def csl_vjp(tag, cholesky, gram, g, one, dev):
    """The fused Cholesky's f64 VJP at Np = 1024, 2048 and 10048 (RBF
    operands of lengthscale 0.1 and unit noise, one right-hand side), by
    one call between CUDA events and one call queued behind a spin
    (device), medians of REPS: the kernels of csrc/chol_inverse.cu where
    the checkout has them, the plain version (torch.linalg in f64, the
    path before them), and its cuBLAS pair alone (the solve against I and
    the full product, from an f64 copy of the factor made beforehand);
    beside the bound 2 Np^3 / 3 at 67 TFLOP/s (f64 tensor cores) and the
    kernels' device time each by the profiler."""
    inverse = getattr(cholesky, "_inverse", None)  # ops.chol_inverse, where the checkout has it
    ghl, gq = torch.tensor(0.5, device=dev), torch.tensor(-0.5, device=dev)
    for n in (1024, 2048, 10048):
        xs = torch.rand(n - 48, 1, generator=g, device=dev) / 0.1
        Kp = gram.gram_chol_operand_cuda("rbf", xs, one, one, n)
        D = torch.zeros(n, 1, device=dev)
        D[:n - 48] = torch.randn(n - 48, 1, generator=g, device=dev)
        Lp, alpha, _ = cholesky.cholesky_solve_cuda(Kp, D)
        bound = 2 * n ** 3 / 3 / cs.F64_TC_FLOPS * 1e3
        t = {}
        if inverse is not None:
            kern = lambda: inverse.csl_vjp_cuda(Lp, alpha, ghl, gq)  # noqa: E731
            t["kernels"] = (statistics.median(cs.cuda_ms(torch, kern)),
                            statistics.median(cs.cuda_ms(torch, kern, queued=True)))
            by = {k: v for k, v in per_kernel_us(kern).items() if k.startswith("kinv")}
            fn = lambda: inverse.csl_vjp_plain(Lp, alpha, ghl, gq)  # noqa: E731
            t["plain"] = (statistics.median(cs.cuda_ms(torch, fn)),
                          statistics.median(cs.cuda_ms(torch, fn, queued=True)))
        L64 = torch.tril(Lp).double()
        eye = torch.eye(n, dtype=torch.float64, device=dev)

        def pair():
            Linv = torch.linalg.solve_triangular(L64, eye, upper=False)
            return Linv.T @ Linv

        t["cublas_pair"] = (statistics.median(cs.cuda_ms(torch, pair)),
                            statistics.median(cs.cuda_ms(torch, pair, queued=True)))
        rate = (f", {2 * n ** 3 / 3 / t['kernels'][1] / 1e9:.1f} TFLOP/s of the 2 Np^3 / 3 (device); "
                f"per kernel (us, launches) {by}") if "kernels" in t else ""
        print(f"{tag} csl_vjp Np={n} (bound {bound:.4f} ms): " + ", ".join(
            f"{name} {ms:.4f} ms (device {dms:.4f})" for name, (ms, dms) in t.items()) + rate, flush=True)
        del L64, eye


def nkn_operand(tag, g, dev):
    """The NKN operand of csrc/nkn_operand.cu (the paper's time-series
    network, D = 1, chip_smoke.py's ``nkn_published_kernel``) and its VJP alone, at N = 10000 padded to
    10048 and N = 2048: by the kernels line's three methods and the
    profiler, against the plain versions (the forward in float32 and the
    closed-form VJP in float64, torch on the card), beside the bounds: the
    operand's lower triangle written (forward), the cotangent's lower
    triangle read (VJP), at 3.35 TB/s, and each side's multiply-adds at
    67 TFLOP/s (f32; port_bench/metrics/nkn_train.operand_roofline.py's
    count)."""
    try:
        from gpflow_slim_tpu_torch.ops import nkn
    except ImportError:
        print(f"{tag}: no ops.nkn, no NKN operand", flush=True)
        return
    import gpflow_slim_tpu_torch as gft

    kern = cs.nkn_published_kernel(gft).to(dev)
    noise = torch.tensor(0.1, device=dev)
    for n, pad in ((10000, 10048), (2048, 2048)):
        X = torch.rand(n, 1, generator=g, device=dev)
        with torch.no_grad():
            theta = kern._theta(1, X).float().contiguous()
        kinds = kern._operand_kinds(X)
        G = torch.randn(pad, pad, generator=g, device=dev)
        G = G + G.T
        tri_n, tri_pad = n * (n + 1) // 2, pad * (pad + 1) // 2
        fwd_bound = max(tri_n * 170 / cs.F32_FLOPS, tri_pad * 4 / cs.HBM_BYTES) * 1e3  # 82 MACs, 6 multiplies
        vjp_bound = max(tri_n * 546 / cs.F32_FLOPS, tri_n * 4 / cs.HBM_BYTES) * 1e3  # 264 MACs, 18 multiplies
        fwd = lambda: nkn.nkn_operand_cuda(X, theta, noise, kinds, pad)  # noqa: E731
        vjp = lambda: nkn.nkn_vjp_cuda(G, X, theta, kinds)  # noqa: E731
        for name, fn, plain, b in (("nkn_operand", fwd, lambda: nkn.nkn_operand_plain(X, theta, noise, kinds, pad),
                                    fwd_bound),
                                   ("nkn_vjp", vjp, lambda: nkn.nkn_vjp_plain(G, X, theta, kinds), vjp_bound)):
            plain_ms = statistics.median(cs.cuda_ms(torch, plain, reps=3))
            text, _ = three(fn)
            print(f"{tag} {name} N={n} pad_to={pad} (bound {b:.4f} ms): {text}; plain {plain_ms:.4f} ms",
                  flush=True)
        del G
        torch.cuda.empty_cache()


def main():
    args = [a for a in sys.argv[1:] if a not in ("--gram", "--chol", "--lower", "--kinv", "--nkn")]
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
    if "--chol" in sys.argv:
        chol_modes(tag, cholesky, gram, g, one, dev)
        return 0
    if "--lower" in sys.argv:
        lower_gram(tag, gram, g, one, dev)
        return 0
    if "--kinv" in sys.argv:
        csl_vjp(tag, cholesky, gram, g, one, dev)
        return 0
    if "--nkn" in sys.argv:
        nkn_operand(tag, g, dev)
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
