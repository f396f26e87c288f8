#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpflow_slim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives three paths of the port through its public entry points, and
checks them: the exact-GPR marginal-likelihood (training) path and serving
path (posterior and predictions) at bench.py's size (N=10000, D=1, RBF with
lengthscale 0.1, float32), and the SVGP natural-gradient training path at
benchmarks/bench_svgp_nuts.py's size (N=100000, M=256 inducing points,
minibatches of 1024, Bernoulli, RBF with lengthscale 0.2, float32),
unwhitened (the path of the batched TRSM) and whitened.

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: the hand-written kernels with nvcc for sm_90a from csrc/ (one
   nvcc per source, in parallel);
3. each kernel against its plain PyTorch version, run in float64 on the
   card on the same inputs: the Gram operand (six kinds, D = 1 and 3, and
   at the edges of its 8-row bands: N = 1003 padded to 1024, D = 1 and 5)
   and the fused factor/solve/logdet of the training path; the cross Gram
   (10000 x 2048, six kinds and D=3), the lower-tile Gram, the factor-only Cholesky and
   the TRSM (lower, and upper through the transposed view; P = 1, 7, 64,
   2048) of the serving path; the TRSM's thin schedule (P <= 64) at
   N = 1, 63, 64, 65 and P = 1, 64 (lower, upper through the transposed
   view, a view with row stride > N); both Cholesky modes at sides that are
   not multiples of the 256-wide panel (a last panel of 64 and of 192
   columns); the same three at the SVGP path's shapes (the
   cross Gram for Kuu and a 1024-point Kuf, the factor-only Cholesky of the
   config's Kuu, the TRSM of its factor on Kuf, lower and upper through the
   transposed view); the batched TRSM of the SVGP path (P = 1, 16; M =
   1, 64, 65, 200, 256, 1024; K = 1, 32, 33, 40, M, so one block row,
   ragged block rows and 32-column strips, and up to 8192 work items;
   lower, upper through the transposed view, a stride-0 batch; the
   config's chol(Kuu); its backward's gB and dL); the cross Gram at the edges
   of its row bands and sweeps (six kinds, N = 1, 7, 10001, M = 1, 3, 1023,
   2049, D = 1, 3, 8: partial bands, rows that are not 16-byte aligned,
   a last sweep of one column); config #2's shapes: both Cholesky modes on
   its Kuu at M = 64 and 100 (Np = 64 and 128, under one 256-wide panel),
   the TRSM on the M = 100 factor (two block rows, the last ragged) at
   P = 10000, 2047 and 1, lower and upper through the transposed view of
   the padded factor, the cross Gram at 100 x 10000 and 100 x 2047;
4. the training path: GPR.objective() (both of its kernels must launch),
   against an f64 oracle at the effective hyperparameters (gate 1e-5
   relative, as bench.py); the gradient against the f64 plain path (1e-3
   relative); 5 Adam steps of training.fit must lower the loss;
4b. the serving path: GPR.posterior(), four predict_f requests of 2048
   points, one full-covariance request of 1024, predict_y and
   predict_density, and one uncached GPR.predict_f (its four kernels must
   launch); means and variances against an f64 oracle, gated relative to
   the use_kernels=False float32 route;
4c. the SVGP path: the unwhitened ELBO on a fixed minibatch of 1024
   against an f64 oracle written out independently (Gram, Cholesky, the KL
   formula, 20-point Gauss-Hermite of the probit log-likelihood), every
   unconstrained gradient against the f64 plain path, the conjugate oracle
   (one natgrad step with gamma = 1 on a Gaussian SVGP with Z = X lands on
   the GPR log marginal likelihood), each gated relative to the
   use_kernels=False float32 route; 20 steps of fit_svgp_natgrad unwhitened
   (the cross Gram, factor-only Cholesky, TRSM and batched TRSM must
   launch) and whitened (the batched TRSM must not);
4d. composability and precision: torch.func.grad of GPR.objective() with
   respect to the kernel's variance through the kernel route, against
   torch.autograd.grad (the gradient gate); TF32 turned on for the process
   (allow_tf32 and set_float32_matmul_precision("high")), under which the
   use_kernels=False Gram, the kernel route's Gram VJP and the GPR gradient
   must hold to the f64 path within their gates (the package runs the
   Gram expansion with TF32 off); one natgrad_step of the SVGP under
   torch.cuda.set_sync_debug_mode("warn"), counting the host syncs by the
   innermost line of the package they came from (none may come from
   training/natgrad.py);
4e. config #2: SGPR's objective and every unconstrained gradient and its
   compute_upper_bound() against the f64 plain path, the upper bound above
   the ELBO, 5 Adam steps of training.fit, posterior() with a predict_f
   request of 2048 points and a full-covariance one of 1024 against the
   f64 path; GPRFITC's objective, gradients and predict_f likewise (each
   gated relative to the use_kernels=False float32 route); the GPR on the
   composite kernel at N=10000 (K_lower + noise I padded into the fused
   kernel) against an independent f64 oracle at 1e-5 (or twice the stock
   f32 route's error where that misses 1e-5) and its gradient against the
   f64 plain path; SVGP.posterior() against the model's predict_f; each
   path's launches; then a launch check by torch.profiler: one SGPR
   objective+gradient and one composite-GPR objective must run the cross
   Gram, both Cholesky modes and both TRSM schedules, and no library
   factorization or triangular solve;
5. times (CUDA events, median; one call between two events) of each kernel
   against its plain version and the one PyTorch call computing the same
   function where there is one, and of the kernel and the library call by
   two more methods, named apart in the kernels line: the mean of runs of
   20 back-to-back calls (run20_ms) and one call queued behind a spin
   kernel, so the host's launch work is hidden (device_ms); each kernel's
   bound (the larger of its bytes over 3.35 TB/s and its flop over 67
   TFLOP/s), the cross Gram also at the SVGP path's shapes
   (256 x 256, 256 x 1024) and with a ragged M (its scalar-store variant),
   and of each path's entry points, kernel route
   against the use_kernels=False route, with peak memory; the SVGP
   training rate by the host's wall clock, over five interleaved 20-step
   fits per route; config #2's kernels at its shapes and its SGPR
   objective, objective+gradient, GPRFITC objective, posterior() and
   request on both routes.

Any failure raises and exits non-zero. Without a CUDA device, or without
the package beside this file, it exits non-zero and prints no result. The
last line is {"ok": true, "device": {...}}.
"""

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N = 10_000
LENGTHSCALE = 0.1
OPERAND_TOL = 1e-5  # x variance, absolute: f32 rounding of exp and d^2
HLD_TOL = 1e-5      # relative
ALPHA_TOL = 1e-3    # relative, max-norm
OBJECTIVE_TOL = 1e-5  # relative to the f64 oracle (bench.py's gate)
GRAD_TOL = 1e-3     # relative to the f64 plain path
# the factor-only Cholesky against f64: the factor's max-norm relative
# error, and its half-logdet (from its diagonal) relative, the gate the
# fused kernel meets with the same f64 pivots
FACTOR_TOL = 1e-4
FACTOR_HLD_TOL = 1e-5
TRSM_TOL = 1e-3     # relative, max-norm: the fused kernel's alpha gate for the same operation
# serving: the kernel route's max error against the f64 oracle may be at
# most twice the use_kernels=False float32 route's, plus this: predictive
# variance ~ 1 - sum A^2 cancels to ~1e-3 at this density, so a fixed
# relative gate would be a guess; the stock f32 route sets the scale
SERVE_ABS = 1e-6
NQ = 2048           # points per predict_f request
NQ_FULL = 1024      # points of the full-covariance request
REPS = 5
RUN = 20            # calls in a run of the kernels line's run20_ms
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: the spin that queues a call for device_ms
# the SVGP path: benchmarks/bench_svgp_nuts.py's bench_svgp_natgrad model
SVGP_N, SVGP_M, SVGP_B, SVGP_LS = 100_000, 256, 1024, 0.2
SVGP_STEPS, SVGP_GAMMA, SVGP_LR = 20, 0.1, 0.01
SVGP_FITS = 5       # timed 20-step fits per route
SVGP_JITTER = 1e-4  # the f32 jitter; the f64 references use it too, to compute the same function
# SVGP gates: the kernel route's error against the f64 reference may be at
# most twice the use_kernels=False float32 route's, plus these (relative;
# max-norm for gradients): Kuu's f32 condition number (~1e6 at 256 points,
# lengthscale 0.2, jitter 1e-4) sets the scale of both routes' errors
SVGP_VALUE_ABS = 1e-6
SVGP_GRAD_ABS = 1e-5
# BASELINE config #2: benchmarks/bench_svgp_nuts.py's bench_sgpr model
# (SGPR and GPRFITC, N=10000 on [0, 1], M=100 inducing points on a grid,
# Matern32(lengthscale 0.2) + Periodic(period 0.16, lengthscale 0.5))
SPARSE_N, SPARSE_M = 10_000, 100
SPARSE_STEPS = 5    # Adam steps of training.fit
SPARSE_JITTER = 1e-4  # the f32 jitter; the f64 references use it too, to compute the same function
# sparse gates, of the SVGP path's form: the kernel route's error against
# the f64 plain path within twice the use_kernels=False f32 route's, plus
# the repo's fixed gates (bench.py's 1e-5 on an objective, 1e-3 on a
# gradient; relative, max-norm for gradients). The two routes' backwards
# are different formulas (Murray's Cholesky VJP in f64 with the TRSM kernel's
# solves refined, autograd's in f32 through cuSOLVER): their errors on the
# kernel hyperparameters' gradients are of one order on config #2 and
# either may be a few times the other (phase 4e prints both), so twice the
# stock error alone would be a coin flip
SPARSE_VALUE_ABS = OBJECTIVE_TOL
SPARSE_GRAD_ABS = GRAD_TOL
# kernels of the package, by the names the profiler gives their launches;
# any other device kernel whose name holds one of LIBRARY_SOLVES is a
# library factorization or triangular solve
OUR_KERNELS = ("gram_cross_kernel", "gram_lower_kernel", "gram_chol_operand_kernel", "pivot_init_kernel",
               "chol_diag_kernel", "chol_panel_kernel", "chol_inner_update_kernel", "chol_trailing_kernel",
               "logdet_sum_kernel", "trsm_thin_kernel", "trsm_group_kernel", "trsm_update_kernel",
               "batched_trsm_kernel")
LIBRARY_SOLVES = ("trsm", "trsv", "potrf", "potrs", "potri", "getrf", "syrk", "cholesky", "cusolver", "magma")
# the cross Gram's edges: partial 8-row bands, rows that are not 16-byte
# aligned, last 1024-column sweeps of one column, D up to 8 (ARD)
GRAM_EDGE_N, GRAM_EDGE_M, GRAM_EDGE_D = (1, 7, 10_001), (1, 3, 1023, 2049), (1, 3, 8)
# the card's peaks for the bound of each kernel (vendor figures, H100 SXM)
F32_FLOPS = 67e12   # float32 without tensor cores
HBM_BYTES = 3.35e12  # bytes per second


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def bench_data():
    """bench.py's data: RandomState(0), X uniform on [0, 1], a noisy wiggle."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.66 * np.cos(25 * X) + 0.1 * rng.randn(N, 1)).astype(np.float32)
    return X, Y


def cuda_ms(torch, fn, setup=lambda: (), reps=REPS, warmup=2, run=1, queued=False):
    """Milliseconds of fn(*setup()) by CUDA events, one sample per rep: a
    run of ``run`` back-to-back calls between two events, over ``run``;
    setup is untimed. ``queued``: a spin kernel holds the stream while the
    host enqueues the run, so the sample is the device's time alone, the
    host's launch work hidden; a sample whose spin ended before the run was
    enqueued is taken again with a spin twice as long."""
    spin, times = SPIN_CYCLES, []
    while len(times) < warmup + reps:
        args = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(spin)
        start.record()
        for _ in range(run):
            fn(*args)
        end.record()
        late = queued and start.query()  # the device reached the run before the host had enqueued it
        torch.cuda.synchronize()
        if not late:
            times.append(start.elapsed_time(end) / run)
        elif spin < 64 * SPIN_CYCLES:
            spin *= 2
        else:
            raise RuntimeError("the host took longer to enqueue a call than a spin of 64 x SPIN_CYCLES")
    return times[warmup:]


def paired_ms(torch, kernel_fn, plain_fn, setup=lambda: ()):
    """Plain, kernel, kernel, plain; the median of each side's samples."""
    plain = cuda_ms(torch, plain_fn, setup)
    kern = cuda_ms(torch, kernel_fn, setup)
    kern += cuda_ms(torch, kernel_fn, setup)
    plain += cuda_ms(torch, plain_fn, setup)
    return statistics.median(kern), statistics.median(plain)


def other_ms(torch, kernel_fn, library_fn=None, setup=None):
    """The kernels line's times of a kernel (and of its library call) by
    the two other methods, beside its one-call ``ms`` (medians of REPS):
    ``run20_ms``, a run of RUN back-to-back calls between two events, over
    RUN (None for a function that needs a fresh input each call), and
    ``device_ms``, one call queued behind a spin kernel (``cuda_ms``)."""
    def two(fn):
        run = None if setup else statistics.median(cuda_ms(torch, fn, run=RUN))
        return run, statistics.median(cuda_ms(torch, fn, setup or (lambda: ()), queued=True))

    run20, dev_ms = two(kernel_fn)
    lib_run20, lib_dev = two(library_fn) if library_fn else (None, None)
    return {"run20_ms": run20, "device_ms": dev_ms, "library_run20_ms": lib_run20,
            "library_device_ms": lib_dev}


def bound(flop, nbytes):
    """(ms, what bounds it): the least time the card could take for work of
    ``flop`` float32 operations moving ``nbytes`` (each input read once,
    each output written once)."""
    t_ops, t_bytes = flop / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tri_bytes(n):
    """Bytes of the lower triangle of an n x n float32 matrix."""
    return n * (n + 1) // 2 * 4


def oracle_objective(torch, X, Y, ls, var, noise):
    """-log p(Y) of RBF + noise GPR in float64 on the card, written out
    independently of the port (bench.py's oracle formula)."""
    dev = torch.device("cuda")
    Xd = torch.tensor(X, dtype=torch.float64, device=dev) / ls
    Yd = torch.tensor(Y, dtype=torch.float64, device=dev)
    sq = (Xd**2).sum(1)[:, None] - 2 * Xd @ Xd.T + (Xd**2).sum(1)[None, :]
    Kd = var * torch.exp(-0.5 * torch.clamp(sq, min=0)) + noise * torch.eye(
        N, dtype=torch.float64, device=dev)
    Ld = torch.linalg.cholesky(Kd)
    al = torch.linalg.solve_triangular(Ld, Yd, upper=False)
    return -float(
        -0.5 * N * math.log(2 * math.pi) - torch.log(torch.diagonal(Ld)).sum() - 0.5 * (al**2).sum()
    )


def sq_dist64(torch, A, B):
    return torch.clamp((A**2).sum(1)[:, None] - 2 * A @ B.T + (B**2).sum(1)[None, :], min=0)


def oracle_predict(torch, X, Y, Xq, ls, var, noise, full_cov=False):
    """Exact-GPR predictive mean and variance (or covariance) of RBF + noise
    in float64 on the card, written out independently of the port."""
    dev = torch.device("cuda")
    Xd = torch.tensor(X, dtype=torch.float64, device=dev) / ls
    Qd = torch.tensor(Xq, dtype=torch.float64, device=dev) / ls
    Yd = torch.tensor(Y, dtype=torch.float64, device=dev)
    K = var * torch.exp(-0.5 * sq_dist64(torch, Xd, Xd))
    K += noise * torch.eye(len(Xd), dtype=torch.float64, device=dev)
    Ld = torch.linalg.cholesky(K)
    del K
    Kx = var * torch.exp(-0.5 * sq_dist64(torch, Xd, Qd))
    mean = Kx.T @ torch.cholesky_solve(Yd, Ld)
    A = torch.linalg.solve_triangular(Ld, Kx, upper=False)
    if full_cov:
        return mean, var * torch.exp(-0.5 * sq_dist64(torch, Qd, Qd)) - A.T @ A
    return mean, var - (A**2).sum(0)[:, None]


def gate(what, e_k, e_p, absolute):
    """The kernel route's error e_k within twice the use_kernels=False
    float32 route's e_p plus ``absolute``; prints both."""
    limit = 2 * e_p + absolute
    print(f"{what}: kernel route {e_k:.3e}, use_kernels=False f32 route {e_p:.3e} "
          f"(gate 2 x that + {absolute:g} = {limit:.3e})")
    if not e_k <= limit:
        raise AssertionError(f"{what}: kernel route {e_k:.3e} > gate {limit:.3e}")


def check_serving_kernels(torch, gram, cholesky, trsm, Xs, X3s, Kp, var, rng, dev):
    """Phase 3 for the serving path's four kernels; returns each one's max
    abs error and the factor for the timings."""
    errs = {}
    Xq = rng.uniform(0, 1, (NQ, 1)).astype(np.float32)
    Xqs = (torch.tensor(Xq, device=dev) / LENGTHSCALE).contiguous()
    X3q = (torch.tensor(rng.uniform(0, 1, (NQ, 3)), dtype=torch.float32, device=dev) / 0.3).contiguous()
    errs["gram"] = 0.0
    for kind, xs, xq in [(k, Xs, Xqs) for k in gram.KINDS] + [("rbf", X3s, X3q)]:
        got = gram.gram_cuda(kind, xs, xq, var)
        err = float((got.double() - gram.gram_reference(kind, xs.double(), xq.double(), 1.0)).abs().max())
        print(f"gram (cross) {kind:11s} D={xs.shape[1]} ({N} x {NQ}): max abs err {err:.3e} "
              f"(tol {OPERAND_TOL:g} x variance)")
        if not err <= OPERAND_TOL * 1.0:
            raise AssertionError(f"cross-Gram kernel {kind} D={xs.shape[1]} disagrees: {err}")
        errs["gram"] = max(errs["gram"], err)

    got = gram.gram_lower_cuda("rbf", Xs, var)
    ref = gram.gram_lower_plain("rbf", Xs.double(), 1.0)
    t = torch.arange(N, device=dev) // gram.TILE
    upper_tiles = t[:, None] < t[None, :]
    lower = torch.ones(N, N, dtype=torch.bool, device=dev).tril_()
    errs["gram_lower"] = float((got.double() - ref)[lower].abs().max())
    upper_zero = bool((got[upper_tiles] == 0).all())
    print(f"gram_lower rbf N={N}: max abs err on the lower triangle {errs['gram_lower']:.3e} "
          f"(tol {OPERAND_TOL:g} x variance); strictly-upper tiles exactly 0: {upper_zero}")
    if not (errs["gram_lower"] <= OPERAND_TOL * 1.0 and upper_zero):
        raise AssertionError("lower-tile Gram kernel disagrees with its plain version")
    del got, ref, upper_tiles, lower

    Lp = cholesky.cholesky_cuda(Kp.clone())
    L = Lp[:N, :N].tril_()  # as ops.cholesky.cholesky leaves it: a view with row stride Np
    L_ref = cholesky.cholesky_plain(torch.tril(Kp[:N, :N]).double())
    errs["cholesky"] = float((L.double() - L_ref).abs().max())
    rel = errs["cholesky"] / float(L_ref.abs().max())
    h_ref = float(torch.log(torch.diagonal(L_ref)).sum())
    h_rel = abs(float(torch.log(torch.diagonal(L).double()).sum()) - h_ref) / abs(h_ref)
    print(f"cholesky (factor only) N={N}, padded to {Kp.shape[0]}: factor rel err {rel:.3e} "
          f"(tol {FACTOR_TOL:g}), half_logdet rel err {h_rel:.3e} (tol {FACTOR_HLD_TOL:g})")
    if not (rel <= FACTOR_TOL and h_rel <= FACTOR_HLD_TOL):
        raise AssertionError("factor-only Cholesky kernel disagrees with its plain version")

    errs["trsm"] = 0.0
    Ld = L.double()
    for P in (1, 7, 64, NQ):
        B = torch.tensor(rng.randn(N, P), dtype=torch.float32, device=dev)
        for name, T, Td, lo in (("lower", L, Ld, True), ("upper, L.T view", L.T, Ld.T, False)):
            got = trsm.trsm_cuda(T, B, lo)
            want = torch.linalg.solve_triangular(Td, B.double(), upper=not lo)
            err = float((got.double() - want).abs().max())
            rel = err / float(want.abs().max())
            print(f"trsm {name} P={P}: rel err {rel:.3e} (tol {TRSM_TOL:g})")
            if not rel <= TRSM_TOL:
                raise AssertionError(f"TRSM kernel ({name}, P={P}) disagrees with its plain version")
            errs["trsm"] = max(errs["trsm"], err)
    del Ld
    return errs, Xqs, Lp, L


def check_gram_edges(torch, gram, dev):
    """Phase 3 at the edges of the cross Gram's bands and sweeps: every kind
    at each (N, M, D) of the grid against ``gram_reference`` in f64, X2s
    sharing its first rows with Xs (d = 0, where Matern12 is steepest).
    Returns the max abs error (at variance 1.7, gated at 1e-5 x variance)."""
    rng = np.random.RandomState(6)
    var, worst = 1.7, 0.0
    for D in GRAM_EDGE_D:
        for n in GRAM_EDGE_N:
            xs = torch.tensor(rng.uniform(0, 1, (n, D)) / 0.3, dtype=torch.float32, device=dev)
            for m in GRAM_EDGE_M:
                x2 = torch.tensor(rng.uniform(0, 1, (m, D)) / 0.3, dtype=torch.float32, device=dev)
                k = min(n, m)
                x2[:k] = xs[:k]
                errs = {}
                for kind in gram.KINDS:
                    got = gram.gram_cuda(kind, xs, x2, torch.tensor(var, device=dev))
                    want = gram.gram_reference(kind, xs.double(), x2.double(), var)
                    errs[kind] = float((got.double() - want).abs().max())
                worst = max(worst, *errs.values())
                if not max(errs.values()) <= OPERAND_TOL * var:
                    raise AssertionError(f"cross-Gram kernel disagrees at N={n} M={m} D={D}: {errs}")
        print(f"gram (cross) edges D={D}, N in {GRAM_EDGE_N}, M in {GRAM_EDGE_M}, six kinds: max abs err "
              f"{worst:.3e} (tol {OPERAND_TOL:g} x variance {var})")
    return worst


def check_schedule_edges(torch, gram, cholesky, trsm, rng, dev):
    """Phase 3 at the edges of the redesigned schedules: the TRSM's thin
    schedule at small and ragged N, and both Cholesky modes at sides whose
    last 256-wide panel is narrower. Returns the max abs errors."""
    errs = {"trsm": 0.0, "cholesky": 0.0, "chol_solve": 0.0}
    for N in (1, 63, 64, 65):
        Lw = np.tril(rng.randn(N, N)) * 0.1 + 2 * np.eye(N)
        buf = torch.zeros(N, N + 3, dtype=torch.float32, device=dev)
        buf[:, :N] = torch.tensor(Lw, dtype=torch.float32, device=dev)
        Lv = buf[:, :N]  # a view with row stride N + 3
        Ld = Lv.double()
        for P in (1, 64):
            B = torch.tensor(rng.randn(N, P), dtype=torch.float32, device=dev)
            for name, T, Td, lo in (("lower, ld > N", Lv, Ld, True), ("upper, .T of ld > N", Lv.T, Ld.T, False),
                                    ("lower, contiguous", Lv.contiguous(), Ld, True)):
                got = trsm.trsm_cuda(T, B, lo)
                want = torch.linalg.solve_triangular(Td, B.double(), upper=not lo)
                err = float((got.double() - want).abs().max())
                rel = err / float(want.abs().max())
                print(f"trsm thin N={N} P={P} {name}: rel err {rel:.3e} (tol {TRSM_TOL:g})")
                if not rel <= TRSM_TOL:
                    raise AssertionError(f"TRSM thin schedule (N={N}, P={P}, {name}) disagrees")
                errs["trsm"] = max(errs["trsm"], err)
    # Np = 320: one full panel and one of 64 columns; 1216: four full
    # panels and one of 192
    for n in (300, 1200):
        Np = n + (-n) % cholesky.BLOCK
        xs = torch.tensor(rng.uniform(0, 1, (n, 1)) / 0.2, dtype=torch.float32, device=dev)
        Kp = gram.gram_chol_operand_cuda("matern52", xs, 1.0, 0.5, Np)
        L_ref = cholesky.cholesky_plain(torch.tril(Kp).double())
        Lg = torch.tril(cholesky.cholesky_cuda(Kp.clone()))
        e = float((Lg.double() - L_ref).abs().max())
        rel = e / float(L_ref.abs().max())
        h_ref = float(torch.log(torch.diagonal(L_ref)).sum())
        h_rel = abs(float(torch.log(torch.diagonal(Lg).double()).sum()) - h_ref) / abs(h_ref)
        print(f"cholesky (factor only) Np={Np} (last panel {Np % 256 or 256} wide): factor rel err "
              f"{rel:.3e} (tol {FACTOR_TOL:g}), half_logdet rel err {h_rel:.3e} (tol {FACTOR_HLD_TOL:g})")
        if not (rel <= FACTOR_TOL and h_rel <= FACTOR_HLD_TOL):
            raise AssertionError(f"factor-only Cholesky disagrees at Np={Np}")
        errs["cholesky"] = max(errs["cholesky"], e)
        for P in (1, 9):
            Dp = torch.zeros(Np, P, dtype=torch.float32, device=dev)
            Dp[:n] = torch.tensor(rng.randn(n, P), dtype=torch.float32, device=dev)
            _, a_ref, h_ref = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
            _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
            h_rel = abs(float(h_got) - float(h_ref)) / abs(float(h_ref))
            a_abs = float((a_got.double() - a_ref).abs().max())
            a_rel = a_abs / float(a_ref.abs().max())
            pad_zero = bool((a_got[n:] == 0).all())
            print(f"chol_solve Np={Np} P={P}: half_logdet rel err {h_rel:.3e} (tol {HLD_TOL:g}), alpha rel "
                  f"err {a_rel:.3e} (tol {ALPHA_TOL:g}), pad rows of alpha exactly 0: {pad_zero}")
            if not (h_rel <= HLD_TOL and a_rel <= ALPHA_TOL and pad_zero):
                raise AssertionError(f"fused Cholesky disagrees at Np={Np}, P={P}")
            errs["chol_solve"] = max(errs["chol_solve"], a_abs)
    return errs


def serving_requests(gft, torch, model):
    """The serving path through its public entry points: returns the
    cached posterior and each request's answer."""
    rq = np.random.RandomState(2)
    requests = [rq.uniform(0, 1, (NQ, 1)).astype(np.float32) for _ in range(4)]
    Xf = rq.uniform(0, 1, (NQ_FULL, 1)).astype(np.float32)
    Xy = rq.uniform(0, 1, (NQ, 1)).astype(np.float32)
    Yy = (np.sin(12 * Xy) + 0.66 * np.cos(25 * Xy) + 0.1 * rq.randn(NQ, 1)).astype(np.float32)
    with torch.no_grad():
        post = model.posterior()
        out = {"requests": requests, "Xf": Xf,
               "predict_f": [post.predict_f(q) for q in requests],
               "full_cov": post.predict_f(Xf, full_cov=True),
               "predict_y": post.predict_y(Xy),
               "predict_density": post.predict_density(Xy, Yy),
               "uncached": model.predict_f(requests[0])}
    return post, out


def svgp_data():
    """bench_svgp_natgrad's data: RandomState(0), X uniform on [0, 1],
    Y = (sin(10 X) > 0), and M inducing points on a grid."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (SVGP_N, 1)).astype(np.float32)
    Y = (np.sin(10 * X) > 0).astype(np.float32)
    Z = np.linspace(0, 1, SVGP_M, dtype=np.float32)[:, None]
    return X, Y, Z


def svgp_model(gft, torch, whiten, dtype):
    X, Y, Z = svgp_data()
    return gft.models.SVGP(X, Y, kern=gft.kernels.RBF(1, lengthscales=SVGP_LS),
                           likelihood=gft.likelihoods.Bernoulli(), Z=Z, whiten=whiten,
                           device="cuda", dtype=dtype)


def oracle_elbo(torch, Xb, Yb, Z, ls, var, q_mu, q_sqrt, whiten):
    """The SVGP minibatch ELBO of RBF + Bernoulli (probit) with one output
    in float64 on the card, written out independently of the port: the
    Grams, the Cholesky of Kuu, the Gaussian KL and 20-point Gauss-Hermite
    of the probit log-likelihood."""
    dev = torch.device("cuda")

    def f64(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev)

    Zs, Xs = f64(Z) / ls, f64(Xb) / ls
    M = Zs.shape[0]
    Kuu = var * torch.exp(-0.5 * sq_dist64(torch, Zs, Zs))
    Kuu += SVGP_JITTER * torch.eye(M, dtype=torch.float64, device=dev)
    Kuf = var * torch.exp(-0.5 * sq_dist64(torch, Zs, Xs))
    Lu = torch.linalg.cholesky(Kuu)
    m, Lq = f64(q_mu), torch.tril(f64(q_sqrt)[0])
    A = torch.linalg.solve_triangular(Lu, Kuf, upper=False)
    logdet_q = torch.log(torch.diagonal(Lq) ** 2).sum()
    if whiten:
        W = A
        kl = 0.5 * ((m ** 2).sum() + (Lq ** 2).sum() - M - logdet_q)
    else:
        W = torch.linalg.solve_triangular(Lu.T, A, upper=True)
        kl = 0.5 * ((torch.linalg.solve_triangular(Lu, m, upper=False) ** 2).sum()
                    + (torch.linalg.solve_triangular(Lu, Lq, upper=False) ** 2).sum() - M
                    + 2 * torch.log(torch.diagonal(Lu)).sum() - logdet_q)
    mean = (W.T @ m)[:, 0]
    fvar = var - (A ** 2).sum(0) + ((Lq.T @ W) ** 2).sum(0)
    x, w = np.polynomial.hermite.hermgauss(20)
    f = mean[None, :] + torch.sqrt(2 * fvar)[None, :] * f64(x)[:, None]  # (20, B)
    p = 0.5 * (1 + torch.erf(f / math.sqrt(2))) * (1 - 2e-3) + 1e-3
    logp = torch.log(torch.where(f64(Yb)[:, 0][None, :] == 1, p, 1 - p))
    ve = (f64(w / math.sqrt(math.pi))[:, None] * logp).sum(0)
    return float(ve.sum() * (SVGP_N / len(Xb)) - kl)


def check_svgp_kernels(torch, gram, cholesky, trsm, dev):
    """Phase 3 for the serving kernels at the SVGP path's shapes: the cross
    Gram for Kuu (256 x 256) and Kuf (256 x 1024), the factor-only Cholesky
    of the config's Kuu and the TRSM of its factor on Kuf (lower, and upper
    through the transposed view, as base_conditional calls them). Returns
    each one's max abs error and the f32 Kuu."""
    errs = {}
    X, _, Z = svgp_data()
    Zs = torch.tensor(Z, device=dev) / SVGP_LS
    Xbs = torch.tensor(X[np.random.RandomState(3).permutation(SVGP_N)[:SVGP_B]], device=dev) / SVGP_LS
    var = torch.tensor(1.0, dtype=torch.float32, device=dev)
    errs["gram"], K = 0.0, {}
    for what, xs in (("Kuu", Zs), ("Kuf", Xbs)):
        K[what] = gram.gram_cuda("rbf", Zs, xs, var)
        ref = gram.gram_reference("rbf", Zs.double(), xs.double(), 1.0)
        err = float((K[what].double() - ref).abs().max())
        print(f"gram (cross) rbf {what} ({SVGP_M} x {xs.shape[0]}): max abs err {err:.3e} "
              f"(tol {OPERAND_TOL:g} x variance)")
        if not err <= OPERAND_TOL * 1.0:
            raise AssertionError(f"cross-Gram kernel disagrees at the SVGP shape {what}: {err}")
        errs["gram"] = max(errs["gram"], err)
    Kuu = K["Kuu"] + SVGP_JITTER * torch.eye(SVGP_M, device=dev)
    Kuf = K["Kuf"]

    # the factor: cond(Kuu) ~1e6 puts f32's own factor error near 1e-3
    # (LAPACK's f32 potrf gives 6e-4 on this Kuu), so the factor is gated
    # like the SVGP path, by twice the stock f32 route's (cuSOLVER's) error
    # plus FACTOR_TOL; the half-logdet keeps its fixed gate
    L_ref = cholesky.cholesky_plain(Kuu.double())
    Lm = cholesky.cholesky_cuda(Kuu.clone()).tril_()  # M = 256 needs no padding
    errs["cholesky"] = float((Lm.double() - L_ref).abs().max())
    lib_rel = float((torch.linalg.cholesky(Kuu).double() - L_ref).abs().max()) / float(L_ref.abs().max())
    h_ref = float(torch.log(torch.diagonal(L_ref)).sum())
    h_rel = abs(float(torch.log(torch.diagonal(Lm).double()).sum()) - h_ref) / abs(h_ref)
    gate(f"cholesky (factor only) of the config's Kuu (M={SVGP_M}) factor rel err vs f64",
         errs["cholesky"] / float(L_ref.abs().max()), lib_rel, FACTOR_TOL)
    print(f"cholesky (factor only) of the config's Kuu: half_logdet rel err {h_rel:.3e} "
          f"(tol {FACTOR_HLD_TOL:g})")
    if not h_rel <= FACTOR_HLD_TOL:
        raise AssertionError("factor-only Cholesky's half_logdet disagrees on the config's Kuu")

    # the solves of base_conditional on the kernel's own factor: A = Lm^-1
    # Kuf, then Lm^-T A through the transposed view
    Ld = Lm.double()
    A = trsm.trsm_cuda(Lm, Kuf, True)
    W = trsm.trsm_cuda(Lm.T, A, False)
    errs["trsm"] = 0.0
    for name, got, Td, B, lo in (("lower, Lm^-1 Kuf", A, Ld, Kuf, True),
                                 ("upper, Lm.T view, Lm^-T A", W, Ld.T, A, False)):
        want = torch.linalg.solve_triangular(Td, B.double(), upper=not lo)
        err = float((got.double() - want).abs().max())
        rel = err / float(want.abs().max())
        print(f"trsm {name} ({SVGP_M} x {SVGP_B}) on the config's chol(Kuu): rel err {rel:.3e} "
              f"(tol {TRSM_TOL:g})")
        if not rel <= TRSM_TOL:
            raise AssertionError(f"TRSM kernel ({name}) disagrees at the SVGP shape")
        errs["trsm"] = max(errs["trsm"], err)
    return errs, Kuu


def check_batched_trsm(torch, trsm, Luu, rng, dev):
    """Phase 3 for the batched TRSM: each mode at each shape, the config's
    chol(Kuu), and the backward; returns the max abs error."""
    worst = 0.0

    def compare(got, want):
        nonlocal worst
        err = float((got.double() - want).abs().max())
        worst = max(worst, err)
        return err / float(want.abs().max())

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for P in (1, 16):
        for M in (1, 64, 65, 200, 256, 1024):
            L = np.stack([np.tril(rng.randn(M, M)) + M * np.eye(M) for _ in range(P)])
            L = torch.tensor(L, dtype=torch.float32, device=dev)
            Ld = L.double()
            rels = {"lower": 0.0, "upper, L.mT view": 0.0, "stride-0 batch": 0.0}
            Ks = sorted({1, 32, 33, 40, M})
            for K in Ks:
                B = torch.tensor(rng.randn(P, M, K), dtype=torch.float32, device=dev)
                for name, T, Td, lower in (
                        ("lower", L, Ld, True), ("upper, L.mT view", L.mT, Ld.mT, False),
                        ("stride-0 batch", L[:1].expand(P, -1, -1), Ld[:1].expand(P, -1, -1), True)):
                    want = trsm.solve_triangular_plain(Td, B.double(), lower)
                    rels[name] = max(rels[name], compare(trsm.batched_trsm_cuda(T, B, lower), want))
            print(f"batched_trsm P={P} M={M} K in {Ks} (up to {trsm.batched_trsm_items(P, M, max(Ks))} "
                  f"work items on {sms} SMs): rel err " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
                  + f" (tol {TRSM_TOL:g})")
            if not max(rels.values()) <= TRSM_TOL:
                raise AssertionError(f"batched TRSM kernel (P={P}, M={M}) disagrees with its plain version")

    # the config's chol(Kuu) (as the KL factors it), against the initial
    # q_sqrt (the identity) and a random right-hand side, and the backward
    Lb, Lbd = Luu[None], Luu.double()[None]
    for name, B in (("identity", torch.eye(SVGP_M, device=dev)[None]),
                    ("random", torch.tensor(rng.randn(1, SVGP_M, SVGP_M), dtype=torch.float32, device=dev))):
        rel = max(compare(trsm.batched_trsm_cuda(Lb, B, True),
                          trsm.solve_triangular_plain(Lbd, B.double(), True)),
                  compare(trsm.batched_trsm_cuda(Lb.mT, B, False),
                          trsm.solve_triangular_plain(Lbd.mT, B.double(), False)))
        print(f"batched_trsm on the config's chol(Kuu) (M={SVGP_M}), {name} right-hand side, lower and "
              f"upper: rel err {rel:.3e} (tol {TRSM_TOL:g})")
        if not rel <= TRSM_TOL:
            raise AssertionError("batched TRSM kernel disagrees on chol(Kuu)")
    B = torch.tensor(rng.randn(1, SVGP_M, SVGP_M), dtype=torch.float32, device=dev)
    G = torch.tensor(rng.randn(1, SVGP_M, SVGP_M), dtype=torch.float32, device=dev)
    grads = []
    for t, b, solve in ((Luu.clone(), B.clone(), trsm.batched_solve_lower),
                        (Luu.double(), B.double(),
                         lambda a, c: trsm.solve_triangular_plain(a, c, True))):
        t.requires_grad_()
        b.requires_grad_()
        torch.sum(solve(t.expand(1, -1, -1), b) * G.to(t.dtype)).backward()
        grads.append((b.grad, t.grad))
    rel_gB, rel_dL = (compare(got, want.double()) for got, want in zip(*grads))
    print(f"batched_trsm backward on chol(Kuu): gB rel err {rel_gB:.3e}, dL rel err {rel_dL:.3e} "
          f"(tol {TRSM_TOL:g})")
    if not (rel_gB <= TRSM_TOL and rel_dL <= TRSM_TOL):
        raise AssertionError("batched TRSM backward disagrees with the plain autograd")
    return worst


def svgp_checks(gft, torch, gram, cholesky, trsm, dev):
    """Phase 4c: checks 1-5 of the SVGP path; returns the launches of the
    unwhitened 20-step fit (the path's run) and the fixed minibatch."""
    X, Y, Z = svgp_data()
    idx = np.random.RandomState(3).permutation(SVGP_N)[:SVGP_B]
    Xb, Yb = X[idx], Y[idx]

    # 1. the unwhitened ELBO on a fixed minibatch, at the model as built
    # (q = N(0, I)). Its KL, ~0.5 tr(Kuu^-1), is most of it: the batched
    # TRSM's Lp^-1 q_sqrt. (Moving q towards the posterior makes the f32
    # gradients' errors larger on both routes, up to O(1) on q_sqrt:
    # cancellations of Kuu^-1-sized terms.)
    m32 = svgp_model(gft, torch, False, torch.float32)
    elbos, grads = {}, {}
    for flag in (True, False):
        with gft.config.temp_settings(use_kernels=flag):
            m32.zero_grad(set_to_none=True)
            elbo = m32.build_likelihood_batch(Xb, Yb)
            (-elbo).backward()
        elbos[flag] = elbo.item()
        grads[flag] = {n: p.unconstrained.grad.double() for n, p in gft.params.parameters(m32)}
    ls = m32.kern.lengthscales.value.item()
    var = m32.kern.variance.value.item()
    oracle = oracle_elbo(torch, Xb, Yb, m32.feature.Z.value.detach().cpu().numpy(), ls, var,
                         m32.q_mu.value.detach().cpu().numpy(), m32.q_sqrt.value.detach().cpu().numpy(),
                         whiten=False)
    print(f"SVGP (unwhitened) minibatch ELBO: kernel route {elbos[True]:.6f}, use_kernels=False "
          f"{elbos[False]:.6f}, f64 oracle {oracle:.6f}")
    gate("SVGP ELBO rel err vs the f64 oracle", abs(elbos[True] - oracle) / abs(oracle),
         abs(elbos[False] - oracle) / abs(oracle), SVGP_VALUE_ABS)

    # 2. every unconstrained gradient against the f64 plain path
    m64 = svgp_model(gft, torch, False, torch.float64)
    gft.interop.load_unconstrained(m64, {
        n: p.unconstrained.detach().cpu().numpy() for n, p in gft.params.parameters(m32)})
    with gft.config.temp_settings(jitter=SVGP_JITTER):
        (-m64.build_likelihood_batch(Xb, Yb)).backward()
    for n, p in gft.params.parameters(m64):
        want = p.unconstrained.grad
        e = [float((grads[flag][n] - want).abs().max()) / float(want.abs().max()) for flag in (True, False)]
        gate(f"SVGP grad {n} {tuple(want.shape)} rel err (max-norm) vs the f64 plain path", *e,
             SVGP_GRAD_ABS)
    del m32, m64

    # 3. the conjugate oracle: a Gaussian SVGP with Z = X; one natgrad step
    # with gamma = 1 lands on the optimal q, whose ELBO is the GPR log
    # marginal likelihood of the same data (up to the jitter's effect)
    rng = np.random.RandomState(4)
    Xc = rng.uniform(0, 1, (SVGP_M, 1)).astype(np.float32)
    Yc = (np.sin(10 * Xc) + 0.1 * rng.randn(SVGP_M, 1)).astype(np.float32)
    gpr = gft.models.GPR(Xc, Yc, kern=gft.kernels.RBF(1, lengthscales=SVGP_LS), device="cuda",
                         dtype=torch.float64)
    with torch.no_grad():
        gpr.likelihood.variance.unconstrained.copy_(
            gpr.likelihood.variance.transform.backward(torch.tensor(0.1, dtype=torch.float64)))
        lml = gpr.build_likelihood().item()
    after = {}
    for key, dtype, flag in (("kernels", torch.float32, True), ("plain f32", torch.float32, False),
                             ("plain f64", torch.float64, False)):
        with gft.config.temp_settings(use_kernels=flag, jitter=SVGP_JITTER):
            mc = gft.models.SVGP(Xc, Yc, kern=gft.kernels.RBF(1, lengthscales=SVGP_LS),
                                 likelihood=gft.likelihoods.Gaussian(variance=0.1), Z=Xc.copy(),
                                 whiten=False, device="cuda", dtype=dtype)
            halvings = int(gft.training.natgrad_step.halvings)
            gft.training.natgrad_step(mc, lambda mm: -mm.build_likelihood(), gamma=1.0)
            with torch.no_grad():
                after[key] = mc.build_likelihood().item()
        halvings = int(gft.training.natgrad_step.halvings) - halvings
        print(f"conjugate oracle ({key}): ELBO after one gamma=1 step {after[key]:.6f}, GPR log "
              f"marginal likelihood {lml:.6f}, gamma halvings {halvings}")
    gate("conjugate oracle rel err vs the GPR log marginal likelihood",
         abs(after["kernels"] - lml) / abs(lml), abs(after["plain f32"] - lml) / abs(lml), SVGP_VALUE_ABS)

    # 4. the path's run: 20 steps of fit_svgp_natgrad on the unwhitened model
    path_kernels = {"gram": gram.gram_cuda, "cholesky": cholesky.cholesky_cuda, "trsm": trsm.trsm_cuda,
                    "batched_trsm": trsm.batched_trsm_cuda}
    for whiten in (False, True):
        model = svgp_model(gft, torch, whiten, torch.float32)
        gen = torch.Generator(device=dev).manual_seed(0)
        ng = gft.training.natgrad_step
        ng.backtracked = ng.halvings = ng.kept = 0
        for fn in path_kernels.values():
            fn.launches = 0
        gram.gram_cuda.by_shape = {}
        _, losses = gft.training.fit_svgp_natgrad(model, SVGP_STEPS, gen, gamma=SVGP_GAMMA,
                                                  learning_rate=SVGP_LR, batch_size=SVGP_B)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in path_kernels.items()}
        losses = losses.cpu().numpy()
        label = "whitened" if whiten else "unwhitened"
        print(f"fit_svgp_natgrad {label}, {SVGP_STEPS} steps: launches {launches}; natgrad steps that "
              f"halved gamma {int(ng.backtracked)}, halvings {int(ng.halvings)}, kept q {int(ng.kept)}; losses "
              f"{np.array2string(losses, precision=2, max_line_width=1000)}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"fit_svgp_natgrad ({label}) gave non-finite losses")
        if whiten:  # 5. the whitened model never forms Kuu in the KL
            if launches["batched_trsm"] != 0:
                raise AssertionError("the whitened SVGP launched the batched TRSM")
        else:
            if not losses[-5:].mean() < losses[:5].mean():
                raise AssertionError("20 natgrad steps did not lower the unwhitened loss")
            if not all(n > 0 for n in launches.values()):
                raise AssertionError(f"the unwhitened SVGP path did not run all four kernels: {launches}")
            svgp_launches = dict(launches, gram_by_shape=dict(gram.gram_cuda.by_shape))
            print(f"  cross Gram launches by shape in it: {svgp_launches['gram_by_shape']}")
    return svgp_launches, (Xb, Yb)


def func_grad_check(gft, torch, gram, cholesky, model):
    """Phase 4d, composability: torch.func.grad of GPR.objective() with
    respect to the kernel's unconstrained variance, through the kernel
    route (both of its kernels must launch), against torch.autograd.grad."""
    class Objective(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self):
            return self.model.objective()

    u = model.kern.variance.unconstrained
    objective = Objective()
    gram.gram_chol_operand_cuda.launches = cholesky.cholesky_solve_cuda.launches = 0
    got = torch.func.grad(lambda v: torch.func.functional_call(
        objective, {"model.kern.variance.unconstrained": v}, ()))(u.detach())
    launches = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches)
    want = torch.autograd.grad(model.objective(), u)[0]
    rel = float((got - want).abs().max()) / float(want.abs().max())
    print(f"torch.func.grad of GPR.objective() w.r.t. kern.variance (kernel route; operand and chol_solve "
          f"launches {launches}): {float(got):.6f}, torch.autograd.grad {float(want):.6f}, rel err {rel:.3e} "
          f"(tol {GRAD_TOL:g})")
    if not (rel <= GRAD_TOL and min(launches) > 0):
        raise AssertionError("torch.func.grad of the GPR objective disagrees or missed the kernels")


def tf32_checks(gft, torch, gram, serve, Xs, Xqs, model, grads64, dev):
    """Phase 4d, precision: with TF32 turned on for the process, the
    use_kernels=False Gram (gated as the serving path's answers: within
    twice its own TF32-off error against f64, + 1e-6), the kernel route's
    Gram VJP and the GPR gradient (the gradient gate against f64) hold, and
    the Gram and VJP equal the same calls with TF32 off; both settings are
    restored at the end."""
    Xq = (Xqs * LENGTHSCALE).contiguous()  # serving inputs, unscaled
    G = torch.tensor(np.random.RandomState(7).randn(N, NQ), dtype=torch.float32, device=dev)

    def gram_and_vjp():
        with gft.config.temp_settings(use_kernels=False), torch.no_grad():
            K = serve.kern.K(serve.X, Xq)
        xs, xq = Xs.clone().requires_grad_(), Xqs.clone().requires_grad_()
        v = torch.tensor(1.0, device=dev, requires_grad=True)
        gs = torch.autograd.grad(torch.sum(gram.stationary_gram("rbf", xs, xq, v) * G), (xs, xq, v))
        return K, gs

    def gpr_grads():
        model.zero_grad(set_to_none=True)
        model.objective().backward()
        return {n: float(p.unconstrained.grad) for n, p in gft.params.parameters(model)}

    K_off, g_off = gram_and_vjp()
    saved = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        A = Xs[:NQ].expand(NQ, 64).contiguous()
        raw = float((A @ A.T - (A.double() @ A.double().T)).abs().max()) / float((A.double() @ A.double().T).max())
        K_on, g_on = gram_and_vjp()
        grads_on = gpr_grads()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
    restored = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == saved
    print(f"TF32 on: an unguarded f32 product ({NQ} x 64 x {NQ}) is {raw:.3e} off f64 (relative); "
          f"settings restored after: {restored}")
    ls, var = (p.value.detach().double() for p in (serve.kern.lengthscales, serve.kern.variance))
    K64 = gram.gram_reference("rbf", serve.X.double() / ls, Xq.double() / ls, var)
    e_off, e_on = (float((K.double() - K64).abs().max()) for K in (K_off, K_on))
    gate(f"TF32 on: use_kernels=False Gram ({N} x {NQ}) max abs err vs f64", e_on, e_off, SERVE_ABS)
    xs, xq, v = (t.double().requires_grad_() for t in (Xs, Xqs, torch.tensor(1.0, device=dev)))
    g64 = torch.autograd.grad(torch.sum(gram.gram_reference("rbf", xs, xq, v) * G.double()), (xs, xq, v))
    e_vjp = max(float((a.double() - b).abs().max()) / float(b.abs().max()) for a, b in zip(g_on, g64))
    e_gpr = max(abs(grads_on[n] - grads64[n]) / abs(grads64[n]) for n in grads64)
    same = torch.equal(K_on, K_off) and all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    print(f"TF32 on: kernel route's Gram VJP rel err (max-norm) vs f64 {e_vjp:.3e}, GPR gradient rel err "
          f"{e_gpr:.3e} (tol {GRAD_TOL:g}); the Gram and its VJP equal the TF32-off calls: {same}")
    if not (e_vjp <= GRAD_TOL and e_gpr <= GRAD_TOL and same and restored):
        raise AssertionError("with TF32 on, the Gram expansion or its VJP lost precision")


def natgrad_syncs(gft, torch, batch, dev):
    """Phase 4d, host syncs: one natgrad_step of the unwhitened SVGP (after
    one warm-up step) under torch.cuda.set_sync_debug_mode("warn"), each
    sync counted at the innermost line of the package on its stack, after
    a probe shows that the hook sees one known sync. Returns the counts."""
    model = svgp_model(gft, torch, False, torch.float32)
    Xb, Yb = (torch.tensor(a, device=dev) for a in batch)

    def loss(mm):
        return -(mm.build_likelihood_batch(Xb, Yb) + mm.log_prior())

    gft.training.natgrad_step(model, loss, SVGP_GAMMA)
    torch.cuda.synchronize()
    counts = collections.Counter()
    pkg = os.path.join(HERE, "gpflow_slim_tpu_torch")

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return  # e.g. the notice that the debug mode is a prototype
        stack = [f for f in traceback.extract_stack()[:-1] if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if f.filename.startswith(pkg)]
        if ours:
            counts[f"{os.path.relpath(ours[-1].filename, HERE)}:{ours[-1].lineno}"] += 1
        else:  # no line of the package on the stack: name the last three frames
            counts[" < ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}" for f in stack[:-4:-1])] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            float(torch.ones((), device=dev))  # a known sync: the hook must see it
            probe, counts = sum(counts.values()), collections.Counter()
            gft.training.natgrad_step(model, loss, SVGP_GAMMA)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if probe != 1:
        raise AssertionError(f"the sync hook counted {probe} syncs for one .item()-like read, not 1")
    mine = sum(n for k, n in counts.items() if k.startswith("gpflow_slim_tpu_torch/training/natgrad.py"))
    print(f"host syncs in one natgrad_step (SVGP, unwhitened, kernel route): {mine} from training/natgrad.py, "
          f"{sum(counts.values()) - mine} from elsewhere {dict(counts)}")
    if mine:
        raise AssertionError(f"natgrad_step synced the host {mine} times")
    return counts


def svgp_times(gft, torch, gram, trsm, batch, rng, dev):
    """Phase 5 for the SVGP path: the cross Gram at the path's two shapes
    and the batched TRSM at three, then the ELBO, one step and the 20-step
    rate on both routes. Returns the rows of the kernels line: the cross
    Gram's at (256, 256) and (256, 1024), the batched TRSM's at the path's
    shape (1, 256, 256)."""
    rows = {}
    X, _, Z = svgp_data()
    Zs = torch.tensor(Z, device=dev) / SVGP_LS
    Xbs = torch.tensor(X[:SVGP_B], device=dev) / SVGP_LS
    var = torch.tensor(1.0, dtype=torch.float32, device=dev)
    for xs in (Zs, Xbs):
        n, m = SVGP_M, xs.shape[0]
        kernel = lambda: gram.gram_cuda("rbf", Zs, xs, var)  # noqa: E731
        k_ms, p_ms = paired_ms(torch, kernel, lambda: gram.gram_reference("rbf", Zs, xs, var))
        b_ms, b_by = bound(5 * n * m, n * m * 4 + (n + m) * 4)
        rows[(n, m)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                        **other_ms(torch, kernel)}
        print(f"  cross gram at the SVGP shape ({n} x {m}): kernel {k_ms:.4f} ms (runs of {RUN} "
              f"{rows[(n, m)]['run20_ms']:.4f}, device {rows[(n, m)]['device_ms']:.4f}), plain f32 "
              f"{p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    for P, M, K in ((1, SVGP_M, SVGP_M), (16, SVGP_M, SVGP_M), (1, 1024, 1024)):
        L = np.stack([np.tril(rng.randn(M, M)) + M * np.eye(M) for _ in range(P)])
        L = torch.tensor(L, dtype=torch.float32, device=dev)
        B = torch.tensor(rng.randn(P, M, K), dtype=torch.float32, device=dev)
        kernel = lambda: trsm.batched_trsm_cuda(L, B, True)  # noqa: E731
        library = lambda: torch.linalg.solve_triangular(L, B, upper=False)  # noqa: E731
        k_ms, p_ms = paired_ms(torch, kernel, lambda: trsm.solve_triangular_plain(L, B, True))
        lib_ms = statistics.median(cuda_ms(torch, library))
        b_ms, b_by = bound(P * M * M * K, P * tri_bytes(M) + 2 * P * M * K * 4)
        r = rows[(P, M, K)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                               "bound_by": b_by, **other_ms(torch, kernel, library)}
        print(f"  batched trsm P={P} M={M} K={K} ({trsm.batched_trsm_items(P, M, K)} work items): kernel "
              f"{k_ms:.4f} ms, plain f32 {p_ms:.4f} ms, torch.linalg.solve_triangular {lib_ms:.4f} ms "
              f"({k_ms / lib_ms:.2f}x); runs of {RUN} {r['run20_ms']:.4f} vs {r['library_run20_ms']:.4f} ms "
              f"({r['run20_ms'] / r['library_run20_ms']:.2f}x); device {r['device_ms']:.4f} vs "
              f"{r['library_device_ms']:.4f} ms ({r['device_ms'] / r['library_device_ms']:.2f}x); "
              f"bound {b_ms:.6f} ms ({b_by})")

    Xb, Yb = (torch.tensor(a, device=dev) for a in batch)

    def routed(fn, flag):
        def run():
            with gft.config.temp_settings(use_kernels=flag):
                fn()
        return run

    ng = gft.training.natgrad_step
    for whiten in (False, True):
        label = "whitened" if whiten else "unwhitened"
        # every timed run starts from the model as built, as
        # bench_svgp_natgrad times its 20 steps (a long f32 natgrad run can
        # reach a q whose precision no longer factors in f32)
        model = svgp_model(gft, torch, whiten, torch.float32)
        init = {n: p.unconstrained.detach().cpu().numpy().copy() for n, p in gft.params.parameters(model)}

        def reset():
            gft.interop.load_unconstrained(model, init)
            return ()

        def elbo():
            with torch.no_grad():
                model.build_likelihood_batch(Xb, Yb)

        def elbo_grad():
            model.zero_grad(set_to_none=True)
            (-model.build_likelihood_batch(Xb, Yb)).backward()

        gen = torch.Generator(device=dev).manual_seed(1)

        def fit(steps):
            gft.training.fit_svgp_natgrad(model, steps, gen, gamma=SVGP_GAMMA, learning_rate=SVGP_LR,
                                          batch_size=SVGP_B)

        for what, fn in (("ELBO", elbo), ("ELBO+grad", elbo_grad), ("natgrad+Adam step", lambda: fit(1))):
            k_ms, p_ms = paired_ms(torch, routed(fn, True), routed(fn, False), setup=reset)
            print(f"  SVGP {label} {what} (B={SVGP_B}, M={SVGP_M}): kernels {k_ms:.3f} ms, "
                  f"use_kernels=False {p_ms:.3f} ms")
        # steps per second of 20-step fits from the model as built, by the
        # host's wall clock (the step is host-bound), the routes interleaved
        seconds = {True: [], False: []}
        stats = {True: [0, 0, 0], False: [0, 0, 0]}
        order = (False, True, True, False) * (SVGP_FITS // 2) + (False, True) * (SVGP_FITS % 2)
        for flag in order:
            reset()
            before = [int(c) for c in (ng.backtracked, ng.halvings, ng.kept)]
            with gft.config.temp_settings(use_kernels=flag):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fit(SVGP_STEPS)
                torch.cuda.synchronize()
                seconds[flag].append(time.perf_counter() - t0)
            stats[flag] = [s + int(a) - b for s, a, b in zip(stats[flag], (ng.backtracked, ng.halvings, ng.kept),
                                                             before)]
        for flag in (True, False):
            route = "kernels" if flag else "use_kernels=False"
            rates = sorted(SVGP_STEPS / s for s in seconds[flag])
            print(f"  svgp_natgrad_iters_per_sec_N{SVGP_N}_M{SVGP_M}_B{SVGP_B}_{label} ({route}): "
                  f"{SVGP_FITS * SVGP_STEPS / sum(seconds[flag]):.2f} steps/s over all "
                  f"{SVGP_FITS} x {SVGP_STEPS} timed steps (wall clock); per fit median "
                  f"{statistics.median(rates):.2f}, min {rates[0]:.2f}, max {rates[-1]:.2f}; natgrad "
                  f"steps that halved gamma {stats[flag][0]} of {SVGP_FITS * SVGP_STEPS}, halvings "
                  f"{stats[flag][1]}, kept q {stats[flag][2]}")
    return rows[(SVGP_M, SVGP_M)], rows[(SVGP_M, SVGP_B)], rows[(1, SVGP_M, SVGP_M)]


def sparse_data():
    """bench_sgpr's data: RandomState(0), X uniform on [0, 1], Y = sin(12 X)
    + 0.3 sin(40 X) + 0.1 noise, and M inducing points on a grid."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (SPARSE_N, 1)).astype(np.float32)
    Y = (np.sin(12 * X) + 0.3 * np.sin(40 * X) + 0.1 * rng.randn(SPARSE_N, 1)).astype(np.float32)
    Z = np.linspace(0, 1, SPARSE_M, dtype=np.float32)[:, None]
    return X, Y, Z


def sparse_kern(gft):
    return gft.kernels.Matern32(1, lengthscales=0.2) + gft.kernels.Periodic(1, period=0.16, lengthscales=0.5)


def sparse_model(gft, torch, cls, dtype, like=None):
    """Config #2's model (``"SGPR"``, ``"GPRFITC"`` or ``"GPR"``) on the card;
    ``like``: a model whose unconstrained values it takes (the same point
    in another dtype)."""
    X, Y, Z = sparse_data()
    kw = {} if cls == "GPR" else {"Z": Z}
    model = getattr(gft.models, cls)(X, Y, kern=sparse_kern(gft), device="cuda", dtype=dtype, **kw)
    if like is not None:
        gft.interop.load_unconstrained(model, {
            n: p.unconstrained.detach().cpu().numpy() for n, p in gft.params.parameters(like)})
    return model


def sparse_kuu(gft, torch, n, dev):
    """Config #2's Kuu (f32) on n grid points with the f32 jitter, and its
    padded system as ops.linalg pads it: ``(K, Kp)``."""
    Z = torch.linspace(0, 1, n, device=dev)[:, None]
    with torch.no_grad():
        K = sparse_kern(gft).to(device=dev, dtype=torch.float32).K(Z) + SPARSE_JITTER * torch.eye(n, device=dev)
    return K, gft.ops.linalg.pad_system(K, torch.zeros(n, 1, device=dev))[0]


def reset_counts(gram, cholesky, trsm):
    for fn in (gram.gram_chol_operand_cuda, gram.gram_cuda, gram.gram_lower_cuda, cholesky.cholesky_cuda,
               cholesky.cholesky_solve_cuda, trsm.trsm_cuda, trsm.batched_trsm_cuda):
        fn.launches = 0
    gram.gram_cuda.by_shape = {}
    trsm.trsm_cuda.by_schedule = {"thin": 0, "wide": 0}


def read_counts(gram, cholesky, trsm):
    return {"operand": gram.gram_chol_operand_cuda.launches, "gram": gram.gram_cuda.launches,
            "gram_lower": gram.gram_lower_cuda.launches, "cholesky": cholesky.cholesky_cuda.launches,
            "chol_solve": cholesky.cholesky_solve_cuda.launches, "trsm_thin": trsm.trsm_cuda.by_schedule["thin"],
            "trsm_wide": trsm.trsm_cuda.by_schedule["wide"], "batched_trsm": trsm.batched_trsm_cuda.launches,
            "gram_by_shape": dict(gram.gram_cuda.by_shape)}


def check_sparse_kernels(gft, torch, gram, cholesky, trsm, dev):
    """Phase 3 at config #2's shapes: both Cholesky modes on its Kuu at M =
    64 and 100 (Np = 64 and 128, less than one 256-wide panel), the wide
    TRSM on the M = 100 factor (a ragged triangle of two block rows) at P =
    10000, 2047 and 1, lower and upper through the transposed view of the
    padded factor, and the cross Gram at 100 x 10000 and 100 x 2047 (six
    kinds). The factor, the half-logdets and the fused alpha are gated at
    twice cuSOLVER's f32 error (the use_kernels=False route) plus their
    fixed gate: Kuu's f32 conditioning sets both (cuSOLVER's f32 alpha is
    ~2e-3 off f64 at M = 100, more than ALPHA_TOL). Returns the max abs
    errors and the M = 100 factor's padded buffer and view."""
    errs = {"cholesky": 0.0, "chol_solve": 0.0, "trsm": 0.0, "gram": 0.0}
    for n in (64, SPARSE_M):
        K, Kp = sparse_kuu(gft, torch, n, dev)
        Np = Kp.shape[0]
        L_ref = cholesky.cholesky_plain(torch.tril(Kp).double())
        Lg = torch.tril(cholesky.cholesky_cuda(Kp.clone()))
        Dp = torch.zeros(Np, 1, device=dev)
        Dp[:n] = torch.tensor(np.random.RandomState(n).randn(n, 1), dtype=torch.float32, device=dev)
        _, a_ref, hs_ref = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
        L_lib, a_lib, hs_lib = cholesky.cholesky_solve_plain(torch.tril(Kp), Dp)  # cuSOLVER in f32
        _, a_got, hs_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
        e = float((Lg.double() - L_ref).abs().max())
        scale = float(L_ref.abs().max())
        hs_ref, h_lib = float(hs_ref), float(torch.log(torch.diagonal(L_lib).double()).sum())
        where = f"config #2's Kuu, M={n} (Np={Np})"
        gate(f"cholesky (factor only) of {where}: factor rel err vs f64", e / scale,
             float((L_lib.double() - L_ref).abs().max()) / scale, FACTOR_TOL)
        gate(f"cholesky (factor only) of {where}: half_logdet rel err",
             abs(float(torch.log(torch.diagonal(Lg).double()).sum()) - hs_ref) / abs(hs_ref),
             abs(h_lib - hs_ref) / abs(hs_ref), FACTOR_HLD_TOL)
        gate(f"chol_solve of {where}: half_logdet rel err", abs(float(hs_got) - hs_ref) / abs(hs_ref),
             abs(float(hs_lib) - hs_ref) / abs(hs_ref), HLD_TOL)
        a_abs = float((a_got.double() - a_ref).abs().max())
        gate(f"chol_solve of {where}: alpha rel err (max-norm)", a_abs / float(a_ref.abs().max()),
             float((a_lib.double() - a_ref).abs().max()) / float(a_ref.abs().max()), ALPHA_TOL)
        if not bool((a_got[n:] == 0).all()):
            raise AssertionError(f"chol_solve of {where}: pad rows of alpha are not exactly 0")
        errs["cholesky"] = max(errs["cholesky"], e)
        errs["chol_solve"] = max(errs["chol_solve"], a_abs)
    Lp = cholesky.cholesky_cuda(Kp.clone())
    L = Lp[:SPARSE_M, :SPARSE_M].tril_()  # as ops.cholesky.cholesky leaves it: row stride 128
    Ld = L.double()
    rng = np.random.RandomState(9)
    for P in (SPARSE_N, NQ - 1, 1):
        B = torch.tensor(rng.randn(SPARSE_M, P), dtype=torch.float32, device=dev)
        for name, T, Td, lo in (("lower", L, Ld, True), ("upper, L.T view", L.T, Ld.T, False)):
            got = trsm.trsm_cuda(T, B, lo)
            want = torch.linalg.solve_triangular(Td, B.double(), upper=not lo)
            err = float((got.double() - want).abs().max())
            rel = err / float(want.abs().max())
            print(f"trsm {name} N={SPARSE_M} (row stride {L.stride(0)}) P={P} ({trsm.trsm_schedule(P)}): rel err "
                  f"{rel:.3e} (tol {TRSM_TOL:g})")
            if not rel <= TRSM_TOL:
                raise AssertionError(f"TRSM kernel ({name}, N={SPARSE_M}, P={P}) disagrees with its plain version")
            errs["trsm"] = max(errs["trsm"], err)
    X, _, Z = sparse_data()
    zs = (torch.tensor(Z, device=dev) / 0.2).contiguous()
    for xs in ((torch.tensor(X, device=dev) / 0.2).contiguous(), (torch.tensor(X[:NQ - 1], device=dev) / 0.2)):
        worst = {}
        for kind in gram.KINDS:
            got = gram.gram_cuda(kind, zs, xs, torch.tensor(1.7, device=dev))
            worst[kind] = float((got.double() - gram.gram_reference(kind, zs.double(), xs.double(), 1.7)).abs().max())
        print(f"gram (cross) at config #2's rows ({SPARSE_M} x {xs.shape[0]}): max abs err "
              + ", ".join(f"{k} {e:.3e}" for k, e in worst.items()) + f" (tol {OPERAND_TOL:g} x variance 1.7)")
        if not max(worst.values()) <= OPERAND_TOL * 1.7:
            raise AssertionError(f"cross-Gram kernel disagrees at {SPARSE_M} x {xs.shape[0]}: {worst}")
        errs["gram"] = max(errs["gram"], *worst.values())
    return errs, Lp, L


def oracle_composite_objective(torch, X, Y, m32):
    """-log p(Y) of GPR with Matern32 + Periodic + noise in float64 on the
    card at m32's effective hyperparameters, written out independently of
    the port (bench.py's oracle formula, config #2's kernel)."""
    dev = torch.device("cuda")
    k0, k1 = m32.kern.kernels
    ls0, var0 = k0.lengthscales.value.item(), k0.variance.value.item()
    ls1, var1, per = k1.lengthscales.value.item(), k1.variance.value.item(), k1.period.value.item()
    noise = m32.likelihood.variance.value.item()
    x = torch.tensor(X[:, 0], dtype=torch.float64, device=dev)
    d = (x[:, None] - x[None, :]).abs()
    K = var0 * (1 + math.sqrt(3) * d / ls0) * torch.exp(-math.sqrt(3) * d / ls0)
    K += var1 * torch.exp(-0.5 * torch.sin(math.pi * d / per) ** 2 / ls1 ** 2)
    del d
    K += noise * torch.eye(len(x), dtype=torch.float64, device=dev)
    L = torch.linalg.cholesky(K)
    del K
    al = torch.linalg.solve_triangular(L, torch.tensor(Y, dtype=torch.float64, device=dev), upper=False)
    return -float(-0.5 * len(x) * math.log(2 * math.pi) - torch.log(torch.diagonal(L)).sum() - 0.5 * (al ** 2).sum())


def value_and_grads(gft, model, use_kernels, fn=lambda m: m.objective()):
    """``fn(model)`` and every unconstrained gradient (f64 copies), on the
    route ``use_kernels`` picks, with the f32 jitter on every route."""
    with gft.config.temp_settings(use_kernels=use_kernels, jitter=SPARSE_JITTER):
        model.zero_grad(set_to_none=True)
        loss = fn(model)
        loss.backward()
    return loss.item(), {n: p.unconstrained.grad.double() for n, p in gft.params.parameters(model)}


def gate_against_f64(what, k32, p32, ref64):
    """Gate the kernel route's value and every gradient against the f64
    plain path, relative to the use_kernels=False f32 route's error."""
    (vk, gk), (vp, gp), (v64, g64) = k32, p32, ref64
    print(f"{what}: kernel route {vk:.6f}, use_kernels=False {vp:.6f}, f64 plain path {v64:.6f}")
    gate(f"{what} rel err vs the f64 plain path", abs(vk - v64) / abs(v64), abs(vp - v64) / abs(v64),
         SPARSE_VALUE_ABS)
    for n, want in g64.items():
        scale = float(want.abs().max())
        gate(f"  grad {n} {tuple(want.shape)} rel err (max-norm)", float((gk[n] - want).abs().max()) / scale,
             float((gp[n] - want).abs().max()) / scale, SPARSE_GRAD_ABS)


def sparse_predictions(gft, torch, model, flag):
    """The SGPR serving requests: posterior(), predict_f at NQ points and a
    full-covariance predict_f at NQ_FULL (for GPRFITC, which has no
    posterior object: the model's predict_f at NQ)."""
    rq = np.random.RandomState(8)
    Xq, Xf = rq.uniform(0, 1, (NQ, 1)).astype(np.float32), rq.uniform(0, 1, (NQ_FULL, 1)).astype(np.float32)
    with gft.config.temp_settings(use_kernels=flag, jitter=SPARSE_JITTER), torch.no_grad():
        if not hasattr(model, "posterior"):
            return {"predict_f": model.predict_f(Xq)}
        post = model.posterior()
        return {"predict_f": post.predict_f(Xq), "full_cov": post.predict_f(Xf, full_cov=True)}


def gate_predictions(what, got, plain, ref):
    """Each answer finite, and within twice the use_kernels=False f32
    route's error against the f64 plain path + SERVE_ABS."""
    for key, outs in got.items():
        for name, k_t, p_t, r_t in zip(("mean", "var"), outs, plain[key], ref[key]):
            if not bool(k_t.isfinite().all()):
                raise AssertionError(f"{what} {key} {name} is not finite")
            gate(f"{what} {key} {name} {tuple(k_t.shape)} max abs err vs the f64 plain path",
                 float((k_t.double() - r_t).abs().max()), float((p_t.double() - r_t).abs().max()), SERVE_ABS)


def sparse_checks(gft, torch, gram, cholesky, trsm, dev):
    """Phase 4e: config #2 at full width through the public entry points.
    SGPR: objective and every gradient against the f64 plain path,
    compute_upper_bound() >= the ELBO, SPARSE_STEPS Adam steps of
    training.fit, posterior() and its requests against the f64 path;
    GPRFITC: objective, gradients, predict_f; GPR on the composite kernel at
    N=10000: the objective against an independent f64 oracle, the gradient
    against the f64 plain path; SVGP.posterior() of the SVGP config
    (unwhitened, after 5 natgrad steps) against the model's predict_f.
    Returns each path's launches (counts set to 0 just before it, read just
    after)."""
    launches = {}
    # SGPR
    m32 = sparse_model(gft, torch, "SGPR", torch.float32)
    m64 = sparse_model(gft, torch, "SGPR", torch.float64, like=m32)
    reset_counts(gram, cholesky, trsm)
    k32 = value_and_grads(gft, m32, True)
    with torch.no_grad():
        elbo, upper = m32.build_likelihood().item(), m32.compute_upper_bound().item()
    _, losses = gft.training.fit(sparse_model(gft, torch, "SGPR", torch.float32), num_steps=SPARSE_STEPS,
                                 learning_rate=0.01)
    preds = sparse_predictions(gft, torch, m32, True)
    torch.cuda.synchronize()
    launches["sgpr"] = read_counts(gram, cholesky, trsm)
    gate_against_f64("SGPR objective", k32, value_and_grads(gft, m32, False), value_and_grads(gft, m64, False))
    ub = [value_and_grads(gft, m, f, lambda mm: mm.compute_upper_bound()) for m, f in ((m32, True), (m32, False),
                                                                                         (m64, False))]
    gate_against_f64("SGPR compute_upper_bound", *ub)
    print(f"SGPR: ELBO {elbo:.6f} <= upper bound {upper:.6f}: {elbo <= upper}")
    losses = losses.cpu().numpy()
    print(f"SGPR fit: {SPARSE_STEPS} Adam steps, losses {np.array2string(losses, precision=4)}; each lower than "
          f"the last: {bool((np.diff(losses) < 0).all())}")
    if not (elbo <= upper and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("SGPR: the upper bound is below the ELBO, or Adam did not lower the loss")
    gate_predictions("SGPR", preds, sparse_predictions(gft, torch, m32, False),
                     sparse_predictions(gft, torch, m64, False))
    print(f"SGPR path (objective+gradient, upper bound, {SPARSE_STEPS} Adam steps, posterior(), predict_f at {NQ}, "
          f"full_cov at {NQ_FULL}): launches {launches['sgpr']}")
    need = ("gram", "cholesky", "trsm_thin", "trsm_wide")
    if not all(launches["sgpr"][k] > 0 for k in need) or launches["sgpr"]["chol_solve"]:
        raise AssertionError(f"the SGPR path did not run the cross Gram, factor and both TRSM schedules "
                             f"(or ran the fused Cholesky): {launches['sgpr']}")
    del m32, m64

    # GPRFITC
    f32 = sparse_model(gft, torch, "GPRFITC", torch.float32)
    f64 = sparse_model(gft, torch, "GPRFITC", torch.float64, like=f32)
    reset_counts(gram, cholesky, trsm)
    k32 = value_and_grads(gft, f32, True)
    preds = sparse_predictions(gft, torch, f32, True)
    torch.cuda.synchronize()
    launches["fitc"] = read_counts(gram, cholesky, trsm)
    gate_against_f64("GPRFITC objective", k32, value_and_grads(gft, f32, False), value_and_grads(gft, f64, False))
    gate_predictions("GPRFITC", preds, sparse_predictions(gft, torch, f32, False),
                     sparse_predictions(gft, torch, f64, False))
    print(f"GPRFITC path (objective+gradient, predict_f at {NQ}): launches {launches['fitc']}")
    if not all(launches["fitc"][k] > 0 for k in need):
        raise AssertionError(f"the GPRFITC path did not run its kernels: {launches['fitc']}")
    del f32, f64

    # GPR on the composite kernel at N=10000: K_lower + noise I, padded,
    # through the fused kernel
    X, Y, _ = sparse_data()
    g32 = sparse_model(gft, torch, "GPR", torch.float32)
    reset_counts(gram, cholesky, trsm)
    with torch.no_grad():
        val = g32.objective().item()
    torch.cuda.synchronize()
    launches["gpr"] = read_counts(gram, cholesky, trsm)
    with torch.no_grad(), gft.config.temp_settings(use_kernels=False):
        val_plain = g32.objective().item()
    oracle = oracle_composite_objective(torch, X, Y, g32)
    e_k, e_p = abs(val - oracle) / abs(oracle), abs(val_plain - oracle) / abs(oracle)
    limit = OBJECTIVE_TOL if e_p <= OBJECTIVE_TOL else 2 * e_p
    print(f"composite GPR objective (N={SPARSE_N}): kernel route {val:.6f}, use_kernels=False {val_plain:.6f}, "
          f"f64 oracle {oracle:.6f}; rel err {e_k:.3e} and {e_p:.3e} (gate {limit:.3e}: "
          + ("bench.py's 1e-5" if limit == OBJECTIVE_TOL else "twice the stock f32 route's, which misses 1e-5")
          + f"); launches {launches['gpr']}")
    if not e_k <= limit:
        raise AssertionError(f"composite GPR objective off the f64 oracle by {e_k:.3e}")
    if not (launches["gpr"]["chol_solve"] == 1 and launches["gpr"]["gram"] > 0 and launches["gpr"]["operand"] == 0):
        raise AssertionError(f"the composite GPR did not take the padded fused route: {launches['gpr']}")
    g32.zero_grad(set_to_none=True)
    g32.objective().backward()
    g64 = sparse_model(gft, torch, "GPR", torch.float64, like=g32)
    g64.objective().backward()
    grads64 = dict(gft.params.parameters(g64))
    for n, p in gft.params.parameters(g32):
        want = float(grads64[n].unconstrained.grad)
        rel = abs(float(p.unconstrained.grad) - want) / abs(want)
        print(f"  composite GPR grad {n}: kernel route {float(p.unconstrained.grad):.6f}, f64 plain path "
              f"{want:.6f}, rel err {rel:.3e} (tol {GRAD_TOL:g})")
        if not rel <= GRAD_TOL:
            raise AssertionError(f"composite GPR gradient {n} off the f64 plain path by {rel:.3e}")
    del g32, g64, grads64

    # SVGP.posterior() against the model's own predict_f, at a q away from
    # its initialisation
    model = svgp_model(gft, torch, False, torch.float32)
    gft.training.fit_svgp_natgrad(model, 5, torch.Generator(device=dev).manual_seed(2), gamma=SVGP_GAMMA,
                                  learning_rate=SVGP_LR, batch_size=SVGP_B)
    Xq = np.random.RandomState(10).uniform(0, 1, (NQ, 1)).astype(np.float32)
    reset_counts(gram, cholesky, trsm)
    with torch.no_grad():
        post = model.posterior()
        got = post.predict_f(Xq)
        launches["svgp_posterior"] = read_counts(gram, cholesky, trsm)
        want = model.predict_f(Xq)
    rel = max(float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want))
    print(f"SVGP posterior() (unwhitened, after 5 natgrad steps): predict_f at {NQ} against the model's "
          f"predict_f, rel err (max-norm) {rel:.3e} (tol 1e-5); launches {launches['svgp_posterior']}")
    if not (rel <= 1e-5 and launches["svgp_posterior"]["trsm_wide"] > 0):
        raise AssertionError("SVGPPosterior.predict_f disagrees with SVGP.predict_f or missed the TRSM")
    return launches


def device_kernels(torch, fn):
    """Counter of the device kernels that one call of fn launches, by name,
    from torch.profiler (after one call outside the profile)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                               and "Memcpy" not in e.name and "Memset" not in e.name
                               and "Command Buffer Full" not in e.name)


def ours(name):
    return next((k for k in OUR_KERNELS if k in name), None)


def library_solves(names):
    return {n: c for n, c in names.items() if ours(n) is None and any(w in n.lower() for w in LIBRARY_SOLVES)}


def sparse_launch_check(gft, torch, dev):
    """Phase 4e's launch check by torch.profiler: one SGPR objective+gradient
    and one composite-GPR objective on the kernel route must launch the
    factor-only Cholesky, the cross Gram and both TRSM schedules (SGPR) and
    the fused Cholesky (GPR), and no library factorization or triangular
    solve. A probe shows that the check sees cuBLAS's solve. Returns the
    counts per kernel of each."""
    L = torch.eye(SPARSE_M, device=dev) * 2
    B = torch.ones(SPARSE_M, 1, device=dev)
    probe = library_solves(device_kernels(torch, lambda: torch.linalg.solve_triangular(L, B, upper=False)))
    if not probe:
        raise AssertionError("the launch check does not see torch.linalg.solve_triangular's kernel")
    m = sparse_model(gft, torch, "SGPR", torch.float32)

    def sgpr_step():
        m.zero_grad(set_to_none=True)
        m.objective().backward()

    g = sparse_model(gft, torch, "GPR", torch.float32)

    def gpr_objective():
        with torch.no_grad():
            g.objective()

    counts = {}
    for label, fn, need in (("SGPR objective+gradient", sgpr_step,
                             ("gram_cross_kernel", "chol_diag_kernel", "trsm_thin_kernel", "trsm_group_kernel")),
                            ("composite GPR objective", gpr_objective,
                             ("gram_cross_kernel", "chol_diag_kernel", "logdet_sum_kernel"))):
        names = device_kernels(torch, fn)
        mine = collections.Counter()
        for n, c in names.items():
            if ours(n):
                mine[ours(n)] += c
        libs = library_solves(names)
        counts[label] = dict(mine)
        print(f"launch check, {label} (torch.profiler, kernel route): {dict(mine)}; library factorizations and "
              f"triangular solves: {libs or 'none'} (the probe saw {list(probe)[0][:60]!r})")
        missing = [k for k in need if not mine.get(k)]
        if missing or libs:
            raise AssertionError(f"{label}: kernels missing {missing}, library solves {libs}")
        if label.startswith("SGPR") and mine.get("logdet_sum_kernel"):
            raise AssertionError("the SGPR objective ran the fused Cholesky, not the factor-only one")
    return counts


def sparse_times(gft, torch, gram, cholesky, trsm, Lp, L, rng, dev, card):
    """Phase 5 for config #2: its four kernel rows (the cross Gram at
    100 x 10000, the factor at Np=128, the wide TRSM at N=100 P=10000 and
    the thin one at P=1, each against its plain version and its library
    call), then the SGPR objective, objective+gradient, GPRFITC objective,
    posterior() and one request of NQ points on both routes."""
    rows = {}
    X, Y, Z = sparse_data()
    zs = (torch.tensor(Z, device=dev) / 0.2).contiguous()
    xs = (torch.tensor(X, device=dev) / 0.2).contiguous()
    var = torch.tensor(1.0, device=dev)
    n, m = SPARSE_M, SPARSE_N
    kernel = lambda: gram.gram_cuda("matern32", zs, xs, var)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, kernel, lambda: gram.gram_reference("matern32", zs, xs, var))
    b_ms, b_by = bound(5 * n * m, n * m * 4 + (n + m) * 4)
    rows["gram_sgpr_kuf"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                             **other_ms(torch, kernel)}
    _, Kp = sparse_kuu(gft, torch, n, dev)
    Np = Kp.shape[0]
    k_ms, p_ms = paired_ms(torch, cholesky.cholesky_cuda, cholesky.cholesky_plain, setup=lambda: (Kp.clone(),))
    lib_ms = statistics.median(cuda_ms(torch, torch.linalg.cholesky_ex, setup=lambda: (Kp.clone(),)))
    b_ms, b_by = bound(Np ** 3 / 3, 2 * tri_bytes(Np))
    rows["cholesky_sgpr"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                             **other_ms(torch, cholesky.cholesky_cuda, torch.linalg.cholesky_ex,
                                        setup=lambda: (Kp.clone(),))}
    for name, P in (("trsm_sgpr_wide", m), ("trsm_sgpr_thin", 1)):
        B = torch.tensor(rng.randn(n, P), dtype=torch.float32, device=dev)
        kernel = lambda: trsm.trsm_cuda(L, B, True)  # noqa: E731
        library = lambda: torch.linalg.solve_triangular(L, B, upper=False)  # noqa: E731
        k_ms, p_ms = paired_ms(torch, kernel, lambda: trsm.solve_triangular_plain(L, B, True))
        lib_ms = statistics.median(cuda_ms(torch, library))
        b_ms, b_by = bound(n * n * P, tri_bytes(n) + 2 * n * P * 4)
        rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                      **other_ms(torch, kernel, library)}
    def ms(t):
        return "-" if t is None else f"{t:.4f}"

    for name, r in rows.items():
        print(f"  {name}: kernel {ms(r['ms'])} ms (runs of {RUN} {ms(r['run20_ms'])}, device {ms(r['device_ms'])}), "
              f"plain f32 {ms(r['plain_ms'])} ms, library {ms(r['library_ms'])} ms (runs of {RUN} "
              f"{ms(r['library_run20_ms'])}, device {ms(r['library_device_ms'])}), bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")

    def routed(fn, flag):
        def run():
            with gft.config.temp_settings(use_kernels=flag):
                fn()
        return run

    sgpr = sparse_model(gft, torch, "SGPR", torch.float32)
    fitc = sparse_model(gft, torch, "GPRFITC", torch.float32)

    def objective(model):
        def run():
            with torch.no_grad():
                model.objective()
        return run

    def objective_grad():
        sgpr.zero_grad(set_to_none=True)
        sgpr.objective().backward()

    def posterior():
        with torch.no_grad():
            sgpr.posterior()

    posts = {}
    for flag in (True, False):
        with torch.no_grad(), gft.config.temp_settings(use_kernels=flag):
            posts[flag] = sgpr.posterior()
    Xq = torch.tensor(np.random.RandomState(8).uniform(0, 1, (NQ, 1)), dtype=torch.float32, device=dev)

    def request(flag):
        def run():
            with torch.no_grad(), gft.config.temp_settings(use_kernels=flag):
                posts[flag].predict_f(Xq)
        return run

    print(f"times of config #2 (N={SPARSE_N}, M={SPARSE_M}; median of {2 * REPS} by CUDA events) on {card}:")
    for what, fn in (("SGPR objective", objective(sgpr)), ("SGPR objective+grad", objective_grad),
                     ("GPRFITC objective", objective(fitc)), ("SGPR posterior()", posterior)):
        k_ms, p_ms = paired_ms(torch, routed(fn, True), routed(fn, False))
        print(f"  {what}: kernels {k_ms:.3f} ms ({1e3 / k_ms:.1f} evals/s), use_kernels=False {p_ms:.3f} ms "
              f"({1e3 / p_ms:.1f} evals/s)")
    k_ms, p_ms = paired_ms(torch, request(True), request(False))
    print(f"  SGPR predict_f request, N*={NQ}: kernels {k_ms:.3f} ms, use_kernels=False {p_ms:.3f} ms")
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import gpflow_slim_tpu_torch as gft
    from gpflow_slim_tpu_torch.ops import _build, cholesky, gram, trsm

    pkg_dir = os.path.dirname(os.path.abspath(gft.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise RuntimeError(f"imported gpflow_slim_tpu_torch from {pkg_dir}, not from {HERE}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on at the start: this run checks the default (off), and turns it on "
                           "itself in phase 4d")

    # 1. environment
    nvcc = _build.find_nvcc()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {nvcc}: {nvcc_version}")
    print(f"card: {card}; device count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    print(f"build: {so.name} ready in {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas: {line.strip()}")

    # 3. each kernel against its plain version, in float64 on the card
    X, Y = bench_data()
    pad_to = N + (-N) % cholesky.BLOCK
    var = torch.tensor(1.0, dtype=torch.float32, device=dev)
    noise = torch.tensor(1.0, dtype=torch.float32, device=dev)
    Xs = (torch.tensor(X, device=dev) / LENGTHSCALE).contiguous()
    rng = np.random.RandomState(1)
    X3s = (torch.tensor(rng.uniform(0, 1, (N, 3)), dtype=torch.float32, device=dev) / 0.3).contiguous()
    lower = torch.ones(pad_to, pad_to, dtype=torch.bool, device=dev).tril_()
    operand_err = 0.0
    cases = [(k, Xs) for k in gram.KINDS] + [("rbf", X3s)]
    for kind, xs in cases:
        got = gram.gram_chol_operand_cuda(kind, xs, var, noise, pad_to)
        ref = gram.gram_chol_operand_plain(kind, xs.double(), 1.0, 1.0, pad_to)
        err = float((got.double() - ref)[lower].abs().max())
        print(f"operand {kind:11s} D={xs.shape[1]}: max abs err {err:.3e} (tol {OPERAND_TOL:g} x variance)")
        if not err <= OPERAND_TOL * 1.0:
            raise AssertionError(f"operand kernel {kind} D={xs.shape[1]} disagrees: {err}")
        operand_err = max(operand_err, err)
        del got, ref
    # the edges of the kernel's 8-row bands: N = 1003 (not a multiple of 8)
    # padded to 1024, whose 21 pad rows span whole bands; D = 1 and 5
    erng = np.random.RandomState(5)
    lower_e = torch.ones(1024, 1024, dtype=torch.bool, device=dev).tril_()
    for D in (1, 5):
        xs = torch.tensor(erng.uniform(0, 1, (1003, D)) / 0.3, dtype=torch.float32, device=dev)
        errs = {}
        for kind in gram.KINDS:
            got = gram.gram_chol_operand_cuda(kind, xs, var, noise, 1024)
            ref = gram.gram_chol_operand_plain(kind, xs.double(), 1.0, 1.0, 1024)
            errs[kind] = float((got.double() - ref)[lower_e].abs().max())
        print(f"operand N=1003 D={D} pad_to=1024: max abs err "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {OPERAND_TOL:g} x variance)")
        if not max(errs.values()) <= OPERAND_TOL * 1.0:
            raise AssertionError(f"operand kernel disagrees at the band edges (D={D}): {errs}")
        operand_err = max(operand_err, *errs.values())

    Kp = gram.gram_chol_operand_cuda("rbf", Xs, var, noise, pad_to)
    chol_err = 0.0
    for P in (1, 3, 11):  # 11: wider than the diag kernel's 8-column chunk
        Dp = torch.zeros(pad_to, P, dtype=torch.float32, device=dev)
        Dp[:N, :1] = torch.tensor(Y, device=dev)
        if P > 1:
            Dp[:N, 1:] = torch.tensor(rng.randn(N, P - 1), dtype=torch.float32, device=dev)
        _, a_ref, h_ref = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
        _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
        torch.cuda.synchronize()
        h_rel = abs(float(h_got) - float(h_ref)) / abs(float(h_ref))
        a_abs = float((a_got.double() - a_ref).abs().max())
        a_rel = a_abs / float(a_ref.abs().max())
        pad_zero = bool((a_got[N:] == 0).all())
        print(f"chol_solve P={P}: half_logdet rel err {h_rel:.3e} (tol {HLD_TOL:g}), "
              f"alpha rel err {a_rel:.3e} (tol {ALPHA_TOL:g}), pad rows of alpha exactly 0: {pad_zero}")
        if not (h_rel <= HLD_TOL and a_rel <= ALPHA_TOL and pad_zero):
            raise AssertionError(f"fused kernel P={P} disagrees with its plain version")
        chol_err = max(chol_err, a_abs)

    serve_errs, Xqs, Lp, L = check_serving_kernels(torch, gram, cholesky, trsm, Xs, X3s, Kp, var,
                                                   rng, dev)
    serve_errs["gram"] = max(serve_errs["gram"], check_gram_edges(torch, gram, dev))
    edge_errs = check_schedule_edges(torch, gram, cholesky, trsm, rng, dev)
    serve_errs["trsm"] = max(serve_errs["trsm"], edge_errs["trsm"])
    serve_errs["cholesky"] = max(serve_errs["cholesky"], edge_errs["cholesky"])
    chol_err = max(chol_err, edge_errs["chol_solve"])
    # the SVGP path: its serving kernels at its own shapes, then its batched
    # TRSM with the config's chol(Kuu) as the KL factors it
    svgp_errs, Kuu = check_svgp_kernels(torch, gram, cholesky, trsm, dev)
    serve_errs = {k: max(e, svgp_errs.get(k, 0.0)) for k, e in serve_errs.items()}
    batched_err = check_batched_trsm(torch, trsm, torch.linalg.cholesky(Kuu), rng, dev)
    # config #2: both Cholesky modes at Np = 64 and 128, the TRSM on the
    # M = 100 factor, the cross Gram at 100 rows
    sparse_errs, sparse_Lp, sparse_L = check_sparse_kernels(gft, torch, gram, cholesky, trsm, dev)

    # 4. the training path at full width, through the public entry points
    model = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE),
                           device="cuda", dtype=torch.float32)
    gram.gram_chol_operand_cuda.launches = 0
    cholesky.cholesky_solve_cuda.launches = 0
    with torch.no_grad():
        val = float(model.objective())
    n_opnd, n_chol = gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches
    print(f"objective {val:.6f}; launches in it: operand {n_opnd}, chol_solve {n_chol}")
    if not (n_opnd > 0 and n_chol > 0):
        raise AssertionError("GPR.objective() did not run both kernels")

    ls_eff = model.kern.lengthscales.value.item()
    var_eff = model.kern.variance.value.item()
    noise_eff = model.likelihood.variance.value.item()
    oracle = oracle_objective(torch, X, Y, ls_eff, var_eff, noise_eff)
    rel = abs(val - oracle) / abs(oracle)
    print(f"f64-oracle check (effective ls={ls_eff:.9g}): device={val:.4f} oracle={oracle:.4f} "
          f"rel={rel:.3e} (gate {OBJECTIVE_TOL:g})")
    if not rel <= OBJECTIVE_TOL:
        raise AssertionError(f"objective off the f64 oracle by {rel:.3e}")

    model.zero_grad(set_to_none=True)
    model.objective().backward()
    grads32 = {n: float(p.unconstrained.grad) for n, p in gft.params.parameters(model)}
    m64 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE),
                         device="cuda", dtype=torch.float64)
    gft.interop.load_unconstrained(m64, {
        n: p.unconstrained.detach().cpu().numpy() for n, p in gft.params.parameters(model)})
    m64.objective().backward()
    grads64 = {}
    for n, p in gft.params.parameters(m64):
        g64 = grads64[n] = float(p.unconstrained.grad)
        g_rel = abs(grads32[n] - g64) / abs(g64)
        print(f"grad {n}: kernel route f32 {grads32[n]:.6f}, plain f64 {g64:.6f}, "
              f"rel err {g_rel:.3e} (tol {GRAD_TOL:g})")
        if not g_rel <= GRAD_TOL:
            raise AssertionError(f"gradient {n} off the f64 plain path by {g_rel:.3e}")
    del m64

    fit_model = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE),
                               device="cuda", dtype=torch.float32)
    _, losses = gft.training.fit(fit_model, num_steps=5, learning_rate=0.01)
    losses = losses.cpu().numpy()
    print(f"fit: 5 Adam steps, losses {np.array2string(losses, precision=4)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("5 Adam steps did not lower the loss")
    n_opnd, n_chol = gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches
    print(f"launches over the main path (objective, gradient, 5 steps): "
          f"operand {n_opnd}, chol_solve {n_chol}")

    # 4b. the serving path at full width, through the public entry points
    serve_kernels = {"gram": gram.gram_cuda, "gram_lower": gram.gram_lower_cuda,
                     "cholesky": cholesky.cholesky_cuda, "trsm": trsm.trsm_cuda}
    serve = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE),
                           device="cuda", dtype=torch.float32)
    for fn in serve_kernels.values():
        fn.launches = 0
    trsm.trsm_cuda.by_schedule = {"thin": 0, "wide": 0}
    post, answers = serving_requests(gft, torch, serve)
    torch.cuda.synchronize()
    serve_launches = {name: fn.launches for name, fn in serve_kernels.items()}
    serve_launches.update({f"trsm_{k}": n for k, n in trsm.trsm_cuda.by_schedule.items()})
    print(f"serving path (posterior, 4 x predict_f at {NQ}, full_cov at {NQ_FULL}, predict_y, "
          f"predict_density, uncached predict_f): launches {serve_launches}")
    if not all(n > 0 for n in serve_launches.values()):
        raise AssertionError(f"the serving path did not run all four of its kernels and both TRSM "
                             f"schedules: {serve_launches}")
    shapes = [(NQ, 1)] * 2 * 4 + [(NQ_FULL, 1), (1, NQ_FULL, NQ_FULL)] + [(NQ, 1)] * 5
    tensors = [t for m_v in answers["predict_f"] for t in m_v] + list(answers["full_cov"]) + [
        *answers["predict_y"], answers["predict_density"], *answers["uncached"]]
    for t, shape in zip(tensors, shapes):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"a serving answer is not finite of shape {shape}: {tuple(t.shape)}")

    ls_s = serve.kern.lengthscales.value.item()
    var_s = serve.kern.variance.value.item()
    noise_s = serve.likelihood.variance.value.item()
    with gft.config.temp_settings(use_kernels=False):
        _, plain_answers = serving_requests(gft, torch, serve)
    q0, Xf = answers["requests"][0], answers["Xf"]
    oracles = {"predict_f": oracle_predict(torch, X, Y, q0, ls_s, var_s, noise_s),
               "full_cov": oracle_predict(torch, X, Y, Xf, ls_s, var_s, noise_s, full_cov=True)}
    oracles["uncached"] = oracles["predict_f"]  # the same request, answered without the cache
    for key, (m_o, v_o) in oracles.items():
        got = answers[key] if key != "predict_f" else answers[key][0]
        plain = plain_answers[key] if key != "predict_f" else plain_answers[key][0]
        for what, k_t, p_t, o_t in (("mean", got[0], plain[0], m_o), ("var", got[1], plain[1], v_o)):
            o_t = o_t.reshape(k_t.shape)
            gate(f"serving {key} {what} vs f64 oracle", float((k_t.double() - o_t).abs().max()),
                 float((p_t.double() - o_t).abs().max()), SERVE_ABS)
    del plain_answers, oracles

    # 4c. the SVGP natural-gradient training path at full width
    svgp_launches, svgp_batch = svgp_checks(gft, torch, gram, cholesky, trsm, dev)

    # 4d. composability and precision
    func_grad_check(gft, torch, gram, cholesky, model)
    tf32_checks(gft, torch, gram, serve, Xs, Xqs, model, grads64, dev)
    natgrad_syncs(gft, torch, svgp_batch, dev)

    # 4e. config #2 (SGPR, GPRFITC, the composite GPR) at full width, and
    # the launch check of its kernel route by torch.profiler
    sparse_launches = sparse_checks(gft, torch, gram, cholesky, trsm, dev)
    sparse_launch_check(gft, torch, dev)

    # 5. times on the card, kernel route against plain
    def on_card(ms):
        return f"{ms:.3f} ms"

    Dp1 = torch.zeros(pad_to, 1, dtype=torch.float32, device=dev)
    Dp1[:N] = torch.tensor(Y, device=dev)
    opnd = lambda: gram.gram_chol_operand_cuda("rbf", Xs, var, noise, pad_to)  # noqa: E731
    opnd_ms, opnd_plain_ms = paired_ms(
        torch, opnd, lambda: gram.gram_chol_operand_plain("rbf", Xs, var, noise, pad_to))
    chol = lambda K: cholesky.cholesky_solve_cuda(K, Dp1)  # noqa: E731
    chol_ms, chol_plain_ms = paired_ms(
        torch, chol, lambda K: cholesky.cholesky_solve_plain(K, Dp1), setup=lambda: (Kp.clone(),))
    other = {"gram_chol_operand": other_ms(torch, opnd),
             "chol_solve_logdet": other_ms(torch, chol, setup=lambda: (Kp.clone(),))}

    def objective():
        with torch.no_grad():
            model.objective()

    def objective_grad():
        model.zero_grad(set_to_none=True)
        model.objective().backward()

    def routed(fn, flag):
        def run():
            with gft.config.temp_settings(use_kernels=flag):
                fn()
        return run

    obj_ms, obj_plain_ms = paired_ms(torch, routed(objective, True), routed(objective, False))
    torch.cuda.reset_peak_memory_stats()
    og_ms, og_plain_ms = paired_ms(torch, routed(objective_grad, True),
                                   routed(objective_grad, False))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"times at N={N} (median of {2 * REPS} by CUDA events) on {card}:")
    print(f"  gram_chol_operand: kernel {on_card(opnd_ms)}, plain f32 {on_card(opnd_plain_ms)}")
    print(f"  chol_solve_logdet: kernel {on_card(chol_ms)}, plain f32 {on_card(chol_plain_ms)}")
    print(f"  objective: kernels {on_card(obj_ms)}, use_kernels=False {on_card(obj_plain_ms)}")
    print(f"  objective+grad: kernels {on_card(og_ms)}, use_kernels=False {on_card(og_plain_ms)}; "
          f"peak memory {peak_gb:.2f} GB (the backwards differ: float64 _csl_bwd on the "
          f"kernel route, float32 autograd through cuSOLVER on the other)")

    # the serving path's kernels, at the shapes of its requests
    gram_k = lambda: gram.gram_cuda("rbf", Xs, Xqs, var)  # noqa: E731
    gram_ms, gram_plain_ms = paired_ms(torch, gram_k, lambda: gram.gram_reference("rbf", Xs, Xqs, var))
    Xqr = Xqs[:NQ - 1].contiguous()  # a ragged M: the scalar-store variant
    ragged = {"ms": statistics.median(cuda_ms(torch, lambda: gram.gram_cuda("rbf", Xs, Xqr, var))),
              **other_ms(torch, lambda: gram.gram_cuda("rbf", Xs, Xqr, var))}
    glow_k = lambda: gram.gram_lower_cuda("rbf", Xs, var)  # noqa: E731
    glow_ms, glow_plain_ms = paired_ms(torch, glow_k, lambda: gram.gram_lower_plain("rbf", Xs, var))
    fac_ms, fac_plain_ms = paired_ms(
        torch, cholesky.cholesky_cuda, cholesky.cholesky_plain, setup=lambda: (Kp.clone(),))
    fac_lib_ms = statistics.median(cuda_ms(torch, torch.linalg.cholesky_ex, setup=lambda: (Kp.clone(),)))
    Bq = torch.tensor(rng.randn(N, NQ), dtype=torch.float32, device=dev)
    trsm_k = lambda: trsm.trsm_cuda(L, Bq, True)  # noqa: E731
    trsm_lib = lambda: torch.linalg.solve_triangular(L, Bq, upper=False)  # noqa: E731
    trsm_ms, trsm_plain_ms = paired_ms(torch, trsm_k, lambda: trsm.solve_triangular_plain(L, Bq, True))
    trsm_lib_ms = statistics.median(cuda_ms(torch, trsm_lib))
    B1 = Bq[:, :1].contiguous()
    trsm1_k = lambda: trsm.trsm_cuda(L.T, B1, False)  # noqa: E731
    trsm1_lib = lambda: torch.linalg.solve_triangular(L.T, B1, upper=True)  # noqa: E731
    trsm1_ms, trsm1_plain_ms = paired_ms(torch, trsm1_k, lambda: trsm.solve_triangular_plain(L.T, B1, False))
    trsm1_lib_ms = statistics.median(cuda_ms(torch, trsm1_lib))
    other.update(gram=other_ms(torch, gram_k), gram_lower=other_ms(torch, glow_k),
                 cholesky=other_ms(torch, cholesky.cholesky_cuda, torch.linalg.cholesky_ex,
                                   setup=lambda: (Kp.clone(),)),
                 trsm=other_ms(torch, trsm_k, trsm_lib), trsm_thin=other_ms(torch, trsm1_k, trsm1_lib))

    def build_posterior():
        with torch.no_grad():
            serve.posterior()

    with gft.config.temp_settings(use_kernels=False), torch.no_grad():
        post_plain = serve.posterior()
    q0 = torch.tensor(answers["requests"][0], device=dev)
    Xf_t = torch.tensor(answers["Xf"], device=dev)

    def request(p, q, full_cov=False):
        def run():
            with torch.no_grad():
                p.predict_f(q, full_cov=full_cov)
        return run

    post_ms, post_plain_ms = paired_ms(torch, routed(build_posterior, True),
                                       routed(build_posterior, False))
    req_ms, req_plain_ms = paired_ms(torch, routed(request(post, q0), True),
                                     routed(request(post_plain, q0), False))
    full_ms, full_plain_ms = paired_ms(torch, routed(request(post, Xf_t, True), True),
                                       routed(request(post_plain, Xf_t, True), False))
    peaks = {}
    del post, post_plain
    for flag in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        routed(build_posterior, flag)()
        torch.cuda.synchronize()
        peaks[flag] = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"  cross gram ({N} x {NQ}): kernel {on_card(gram_ms)} (runs of {RUN} {other['gram']['run20_ms']:.4f}, "
          f"device {other['gram']['device_ms']:.4f}), plain f32 {on_card(gram_plain_ms)}; at {N} x {NQ - 1} "
          f"(scalar-store variant) {ragged['ms']:.4f} ms (runs of {RUN} {ragged['run20_ms']:.4f}, device "
          f"{ragged['device_ms']:.4f})")
    print(f"  lower-tile gram ({N}): kernel {on_card(glow_ms)}, plain f32 {on_card(glow_plain_ms)}")
    print(f"  cholesky factor only ({pad_to}): kernel {on_card(fac_ms)}, plain f32 (cuSOLVER) "
          f"{on_card(fac_plain_ms)}, torch.linalg.cholesky_ex {on_card(fac_lib_ms)}")
    print(f"  trsm lower P={NQ} (wide schedule): kernel {on_card(trsm_ms)}, plain f32 (cuBLAS) "
          f"{on_card(trsm_plain_ms)}, torch.linalg.solve_triangular {on_card(trsm_lib_ms)}")
    nb = (N + trsm.BLOCK - 1) // trsm.BLOCK
    print(f"  trsm upper through L.T, P=1 (thin schedule): kernel {on_card(trsm1_ms)} "
          f"({trsm1_ms / nb * 1e3:.2f} us per block row of {nb}), plain f32 {on_card(trsm1_plain_ms)}, "
          f"torch.linalg.solve_triangular {on_card(trsm1_lib_ms)}")
    print(f"  posterior(): kernels {on_card(post_ms)}, use_kernels=False {on_card(post_plain_ms)}; "
          f"peak memory above the model {peaks[True]:.2f} GB and {peaks[False]:.2f} GB")
    print(f"  predict_f request, N*={NQ}: kernels {on_card(req_ms)}, use_kernels=False "
          f"{on_card(req_plain_ms)}")
    print(f"  predict_f full_cov request, N*={NQ_FULL}: kernels {on_card(full_ms)}, use_kernels=False "
          f"{on_card(full_plain_ms)}")

    # the SVGP path
    kuu_row, kuf_row, bt_row = svgp_times(gft, torch, gram, trsm, svgp_batch, rng, dev)
    # config #2
    sparse_rows = sparse_times(gft, torch, gram, cholesky, trsm, sparse_Lp, sparse_L, rng, dev, card)

    # each kernel's bound at the shape it was timed at (D = 1 inputs; a map
    # entry counted as 5 flop: the difference, its square, the scale, exp)
    gram_flop = 5
    bounds = {
        "gram_chol_operand": bound(gram_flop * pad_to * (pad_to + 1) // 2, tri_bytes(pad_to) + N * 4),
        "chol_solve_logdet": bound(pad_to ** 3 / 3 + 2 * pad_to ** 2, 2 * tri_bytes(pad_to) + 2 * pad_to * 4),
        "gram": bound(gram_flop * N * NQ, N * NQ * 4 + (N + NQ) * 4),
        "gram_lower": bound(gram_flop * N * (N + 1) // 2, N * N * 4 + N * 4),
        "cholesky": bound(pad_to ** 3 / 3, 2 * tri_bytes(pad_to)),
        "trsm": bound(N * N * NQ, tri_bytes(N) + 2 * N * NQ * 4),
        "trsm_thin": bound(N * N, tri_bytes(N) + 2 * N * 4),
    }
    print(card)

    def row(name, source, replaces, launches, err, ms, plain_ms, library_ms):
        b_ms, b_by = bounds[name]
        return {"name": name, "route": "cuda", "source": f"gpflow_slim_tpu_torch/csrc/{source}",
                "replaces": f"gpflow_slim_tpu/ops/{replaces}", "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                **other[name]}

    def timed_row(name, source, replaces, launches, err, timed):
        bounds[name] = (timed["bound_ms"], timed["bound_by"])
        other[name] = {k: timed[k] for k in ("run20_ms", "device_ms", "library_run20_ms", "library_device_ms")}
        return row(name, source, replaces, launches, err, timed["ms"], timed["plain_ms"], timed["library_ms"])

    by_shape = svgp_launches["gram_by_shape"]
    print(json.dumps({"kernels": [
        row("gram_chol_operand", "gram_operand.cu", "pallas_gram.py:328", n_opnd, operand_err, opnd_ms,
            opnd_plain_ms, None),
        row("chol_solve_logdet", "chol_solve.cu", "pallas_cholesky.py:857", n_chol, chol_err, chol_ms,
            chol_plain_ms, None),
        row("gram", "gram.cu", "pallas_gram.py:95", serve_launches["gram"], serve_errs["gram"], gram_ms,
            gram_plain_ms, None),
        row("gram_lower", "gram.cu", "pallas_gram.py:173", serve_launches["gram_lower"],
            serve_errs["gram_lower"], glow_ms, glow_plain_ms, None),
        row("cholesky", "chol_solve.cu", "pallas_cholesky.py:716", serve_launches["cholesky"],
            serve_errs["cholesky"], fac_ms, fac_plain_ms, fac_lib_ms),
        row("trsm", "trsm.cu", "pallas_trsm.py:116", serve_launches["trsm_wide"], serve_errs["trsm"], trsm_ms,
            trsm_plain_ms, trsm_lib_ms),
        row("trsm_thin", "trsm.cu", "pallas_trsm.py:116", serve_launches["trsm_thin"], serve_errs["trsm"],
            trsm1_ms, trsm1_plain_ms, trsm1_lib_ms),
        timed_row("gram_svgp_kuu", "gram.cu", "pallas_gram.py:95", by_shape.get((SVGP_M, SVGP_M), 0),
                 svgp_errs["gram"], kuu_row),
        timed_row("gram_svgp_kuf", "gram.cu", "pallas_gram.py:95", by_shape.get((SVGP_M, SVGP_B), 0),
                 svgp_errs["gram"], kuf_row),
        timed_row("batched_trsm", "batched_trsm.cu", "pallas_trsm.py:208", svgp_launches["batched_trsm"],
                 batched_err, bt_row),
        timed_row("gram_sgpr_kuf", "gram.cu", "pallas_gram.py:95",
                 sparse_launches["sgpr"]["gram_by_shape"].get((SPARSE_M, SPARSE_N), 0), sparse_errs["gram"],
                 sparse_rows["gram_sgpr_kuf"]),
        timed_row("cholesky_sgpr", "chol_solve.cu", "pallas_cholesky.py:716", sparse_launches["sgpr"]["cholesky"],
                 sparse_errs["cholesky"], sparse_rows["cholesky_sgpr"]),
        timed_row("trsm_sgpr_wide", "trsm.cu", "pallas_trsm.py:116", sparse_launches["sgpr"]["trsm_wide"],
                 sparse_errs["trsm"], sparse_rows["trsm_sgpr_wide"]),
        timed_row("trsm_sgpr_thin", "trsm.cu", "pallas_trsm.py:116", sparse_launches["sgpr"]["trsm_thin"],
                 sparse_errs["trsm"], sparse_rows["trsm_sgpr_thin"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
