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
   a last sweep of one column);
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
   fits per route.

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

    def svgp_row(name, source, replaces, launches, err, timed):
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
        svgp_row("gram_svgp_kuu", "gram.cu", "pallas_gram.py:95", by_shape.get((SVGP_M, SVGP_M), 0),
                 svgp_errs["gram"], kuu_row),
        svgp_row("gram_svgp_kuf", "gram.cu", "pallas_gram.py:95", by_shape.get((SVGP_M, SVGP_B), 0),
                 svgp_errs["gram"], kuf_row),
        svgp_row("batched_trsm", "batched_trsm.cu", "pallas_trsm.py:208", svgp_launches["batched_trsm"],
                 batched_err, bt_row),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
