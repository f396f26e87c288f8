#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpflow_slim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the paths of the port through its public entry points, and checks
them: the exact-GPR marginal-likelihood (training) path and serving path
(posterior and predictions) at bench.py's size (N=10000, D=1, RBF with
lengthscale 0.1, float32), the SVGP natural-gradient training path at
benchmarks/bench_svgp_nuts.py's size (N=100000, M=256 inducing points,
minibatches of 1024, Bernoulli, RBF with lengthscale 0.2, float32),
unwhitened (the path of the batched TRSM) and whitened, sparse regression
at BASELINE config #2, NUTS over the GPR hyperparameters at BASELINE
config #4 (N=1000, 8 chains) with GPMC and SGPMC, and the full-data
variational path (VGP and VGPOpperArchambeau at N=2048, fit_lbfgs on
entry()'s GPR).

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
   a last sweep of one column); the lower-tile Gram at the edges of its
   bands, tiles and sweeps (six kinds, N = 1, 7, 31, 32, 33, 255, 1003,
   2047, 2048, 4097, 10001, D = 1, 2, 5, 8: 1-row and 8-row bands, N % 4 !=
   0 on the scalar-store variant, a last sweep of one column; every entry
   against the plain version, the strictly-upper 32 x 32 tiles exactly 0,
   one launch a call); config #2's shapes: both Cholesky modes on
   its Kuu at M = 64 and 100 (Np = 64 and 128, under one 256-wide panel),
   the TRSM on the M = 100 factor (two block rows, the last ragged) at
   P = 10000, 2047 and 1, lower and upper through the transposed view of
   the padded factor, the cross Gram at 100 x 10000 and 100 x 2047; both
   Cholesky modes in each split trailing-update mode (syrk "s3", "s4",
   "s3d", "s4d") against their plain split versions at Np = 320, 448, 2048
   and 2112 (last panels of 64 and 192 columns, a last tile of 64), and
   one trailing update alone in each split mode on panel entries whose
   split errs one way, so that the modes part by ~40x the float32
   rounding: each within 1e-6 of its own mode's exact reference and more
   than 3x that from every other mode's, its f64 pivots exact;
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
4f. config #4 (benchmarks/bench_svgp_nuts.py's bench_nuts: GPR, N=1000,
   RBF and noise with LogNormal priors, float32, 8 chains): the batched log
   posterior and gradient of 8 dispersed unconstrained vectors (each kernel
   once per chain) against an independent f64 oracle and the f64 plain
   path, gated within twice the use_kernels=False f32 route's error + 1e-5
   / 1e-3, and against a loop of per-chain autograd calls; a profiler check
   that the batched forward runs the operand and the fused Cholesky once per
   chain and no library factorization or solve; a leaf onto a point whose
   covariance does not factor in f32 diverges; a short NUTS run (max_depth
   8, shared adaptation, 100 warmup draws in Stan windows, 64 retained):
   finite draws, no divergence, the noise posterior's median in
   (0.01, 0.15), the operand and the fused Cholesky launched once per
   active chain per leaf, at most one host sync per leaf step and none
   outside the sampler's loop; then GPMC (Bernoulli, at the largest N of
   1000, 750, 500, 250 whose stock f32 factor is finite) and SGPMC (config
   #2's X and Z, labels Y > 0): the batched log posterior and gradient
   against the f64 plain path (the same composite gates), 5 HMC
   transitions of 8 chains, finite, and a profiler check of the batched
   evaluation and of predict_f (kernels 3, 4, 6, 7 and 8 of PERF.md's
   table, no library factorization or solve);
4g. the full-data variational path (float32, TF32 off): the lower-tile
   Gram of a 64 x 32 grid over [0, 1]^2 (N=2048, D=2), the factor-only
   Cholesky of K + 1e-4 I (Np=2048; cond(K + 1e-4 I) and whether the stock
   f32 factor is finite printed) and the wide TRSM on it at P=2048, lower
   and upper through the transposed view, against their plain versions in
   float64 (the factor and TRSM within twice cuSOLVER's / cuBLAS's f32
   error + 1e-4 / 1e-3), and at phase 3's gates the cross Gram of the
   grid's and of OA's points against themselves (2048 x 2048) and against
   the new points (2048 x 1024), and the operand and fused Cholesky of
   entry()'s GPR (N=2048); a log-Gaussian Cox process (VGP, Poisson, f drawn
   from RBF(2, 0.1) on the grid) and a 3-class MultiClass
   VGPOpperArchambeau (2048 uniform points, labels the argmax of 3 GP
   draws): one ELBO and gradient (the VGP's must launch the lower-tile
   Gram, the factor once and the wide TRSM; Opper-Archambeau's the cross
   Gram and the factor once per latent), 5 Adam steps, then the ELBO and
   every gradient, predict_f and predict_y at 1024 new points and the
   VGP's predict_density, against the f64 plain path, within twice the
   use_kernels=False f32 route's error + 1e-5 / 1e-3 / 1e-6; 5 steps of
   fit_lbfgs on entry()'s GPR (N=2048): finite, non-increasing losses, the
   final objective within 1e-5 of the f64 plain path; OA's half-logdet of
   each A_p (the factor-only kernel; its KL reads it) at the trained
   lambda and at 10x it, within twice cuSOLVER's f32 error + 1e-5; a
   launch check by
   torch.profiler (the VGP ELBO and gradient: no library factorization or
   triangular solve; Opper-Archambeau's: no library factorization, its two
   solves being torch.linalg's as the JAX package's are jax.scipy's);
5. times (CUDA events, median; one call between two events) of each kernel
   against its plain version and the one PyTorch call computing the same
   function where there is one, and of the kernel and the library call by
   two more methods, named apart in the kernels line: the mean of runs of
   20 back-to-back calls (run20_ms) and one call queued behind a spin
   kernel, so the host's launch work is hidden (device_ms), and their
   difference, the host's microseconds a call (host_us; null where the
   one-call time came out below the device time); each kernel's
   bound (the larger of its bytes over 3.35 TB/s and its flop over 67
   TFLOP/s), the cross Gram also at the SVGP path's shapes
   (256 x 256, 256 x 1024) and with a ragged M (its scalar-store variant),
   and of each path's entry points, kernel route
   against the use_kernels=False route, with peak memory; the SVGP
   training rate by the host's wall clock, over five interleaved 20-step
   fits per route; config #2's kernels at its shapes and its SGPR
   objective, objective+gradient, GPRFITC objective, posterior() and
   request on both routes; config #4's operand (N=1000 padded to 1024) and
   fused Cholesky (Np=1024), and one batched log posterior + gradient of its
   8 chains on both routes; the lower-tile Gram at GPMC's N (D=1), with its
   launches in phase 4f's HMC run; the lower-tile Gram at N=2048 (D=2), the factor
   at Np=2048, the wide TRSM at N=P=2048, the cross Gram at 2048 x 2048
   and 2048 x 1024 (D=2), entry()'s operand and fused Cholesky (N=2048) of
   phase 4g, and its VGP and
   Opper-Archambeau ELBO + gradient on both routes with the device's idle
   share and the peak memory; both Cholesky modes in "s3" and "s4" at
   N=10048, held to their plain split versions in f64, timed against them
   in f32 and against cuSOLVER's exact factor (the rows' exact_library_ms;
   library_ms is null, since no PyTorch call computes the split), bound by
   passes x N^3 / 3 flop at the bf16 tensor-core rate.

4h (continued), fault m on the card: mcmc.batched_value_and_grad (vmap of
   grad_and_value) over 2 rows of config #5's streaming GPRCG (N=50000,
   deep kernel, fixed probes): each row against plain autograd at that row
   (1e-5 / 1e-3), the cross Gram exactly once a panel a matvec a row, the
   peak memory above the model under a materialized K's 10 GB;
4i. config #3 from disk: bench_svgp_natgrad's (X, Y) written as a .gfsb
   file, read by io.BinaryDataset's native loader (every prefetched
   minibatch equal to the gather of its indices), 20 steps of
   parallel.make_svgp_step (whitened SVGP, M=256, Adam) on minibatches of
   1024 copied from pinned memory, on a 1-rank nccl world (the cross Gram,
   factor-only Cholesky and wide TRSM launch every step; the loss on a
   fixed batch lower after), dp_value_and_grad against the single-device
   value and gradient (1e-6), the step time, idle share and launches a
   step; utils.check_determinism of one step, then 10 steps, a checkpoint
   of the model, Adam and the generators, a resume into fresh objects and
   10 more, equal bit for bit to 20 uninterrupted steps; bench.py's GPR
   served from a checkpoint: posterior(), save_checkpoint, load_checkpoint
   into a template posterior of the same shapes, 4 predict_f requests of
   2048 points and a full-covariance one of 1024, equal bit for bit to the
   original posterior's, the restored side launching the cross Gram and
   the TRSM and no Cholesky; phase 5 holds its kernels at the shapes they
   ran (the cross Gram at 256 x 256 and 256 x 1024, the factor at M=256,
   the TRSM at N=256, P=1024; the cross Gram at 10000 x 2048 and the TRSM
   at P=2048 on the restored cache) to f64 and times them.
4j. the distributed exact-GP paths on a 1-rank nccl world: BASELINE config
   #5 (example 05's data and deep kernel, N=50000, f32, block 250) through
   parallel.make_distributed_gpr_loss (the ring Gram in 4096-row panels on
   the cross-Gram kernel, the blocked factor with its diagonal blocks on
   the factor-only Cholesky and its panels on the wide TRSM, Murray's
   adjoint through the blocked solves): one objective + gradient under the
   profiler (time, device busy and idle share, peak memory, launches by
   kernel, no library factorization or solve), the value against an f64
   oracle (1e-5; cuSOLVER f64 on the same K, 40 GB) and every gradient
   against the f64 closed form (1e-3); on bench.py's GPR the distributed
   loss against the single device and f64, cyclic_cholesky and
   grid_cholesky (1 x 1 mesh, block 125) against cuSOLVER f64 (factor
   1e-4, half-logdet 1e-5), make_grid_gpr_loss against f64,
   make_distributed_cg_loss on fixed probes within 2% of the exact GPR,
   ring_gram_matvec against K @ v in f64; config #4's 8 chains through
   sample_chains on the 1-rank mesh equal bit for bit to mesh=None;
   entry.dryrun_multichip(1); phase 5 holds the cross Gram at a ring panel,
   the factor at a 250-block and the wide TRSM at N=250, P=49750 to f64
   and times them.
4k. the Cholesky kernels' split-bf16 trailing-update modes (syrk), the JAX
   package's default arithmetic, at that package's own hardware gates
   (tests/test_tpu_compiled.py): the factor of N=2048's RBF Gram (0.1) +
   1e-2 I in "hi", "s3", "s4", "s4d" and "s4x2" through cholesky(),
   Frobenius 5e-4 of f64; the fused "s4" pipeline at N=3000 (noise 0.01)
   against the f64 factor of the device-computed operand, half-logdet 5e-6
   and quad 5e-5; bench.py's GPR objective with its factorization in "s4"
   (1e-5 of the f64 oracle) and its gradient (1e-3 of the f64 plain path),
   "s3" beside it ungated, timed against "hi" and cuSOLVER; each split
   mode's half-logdet on fault l's grid beside "hi"'s and cuSOLVER's
   (printed, not gated); the factor tests must launch the factor-only
   kernel once in each mode they name, and the main path (the objective in
   "s3" and "s4", the counts set to 0 just before it and read just after)
   the fused kernel in "s3" and "s4"; phase 5 holds both kernels at
   N=10048 in "s3" and "s4" to f64 and times them, the factor-only rows
   with 0 launches (no main path runs that kernel in a split mode).

Any failure raises and exits non-zero. Without a CUDA device, or without
the package beside this file, it exits non-zero and prints no result. The
last line is {"ok": true, "device": {...}}.
"""

import collections
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# the f64 VJP's kernels against their plain version on the same f32 factor:
# both f64, sums in another order, so this share of the largest entry on top
# of the kernels' one rounding to f32
VJP_TOL = 1e-10
# the operand's VJP kernel against its plain version: both f64, d^2 by
# differences against the expansion, so this share of each leaf's largest
# entry on top of its one rounding to f32
OPND_VJP_TOL = 1e-9
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
LOGDET_JITTERS = (1e-4, 1e-3, 1e-2)  # fault l's gate: the grid's K + jitter I at Np=2048
LOGDET_TOL = 1e-6   # on top of twice cuSOLVER's f32 error, relative to the f64 half-logdet
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
ZERO_GRAD_REL = 1e-8  # a gradient zero in exact arithmetic, against the largest on the f64 path
# kernels of the package, by the names the profiler gives their launches;
# any other device kernel whose name holds one of LIBRARY_SOLVES is a
# library factorization or triangular solve
OUR_KERNELS = ("gram_cross_kernel", "gram_lower_kernel", "gram_chol_operand_kernel", "pivot_init_kernel",
               "chol_diag_kernel", "chol_panel_kernel", "chol_inner_update_kernel", "chol_trailing_kernel",
               "logdet_sum_kernel", "trsm_thin_kernel", "trsm_group_kernel", "trsm_update_kernel",
               "batched_trsm_kernel", "kinv_diag_kernel", "kinv_left_kernel", "kinv_right_kernel", "kinv_beta_kernel",
               "kinv_beta_sum_kernel", "kinv_kbar_kernel", "gram_operand_vjp_kernel", "gram_operand_vjp_reduce_kernel")
PROFILES = 3  # profiled calls of a launch check
LEAD_IN_CYCLES = 1_000_000  # ~0.5 ms spin at the start of each launch-check profile
LIBRARY_SOLVES = ("trsm", "trsv", "potrf", "potrs", "potri", "getrf", "syrk", "cholesky", "cusolver", "magma")
# the cross Gram's edges: partial 8-row bands, rows that are not 16-byte
# aligned, last 1024-column sweeps of one column, D up to 8 (ARD)
GRAM_EDGE_N, GRAM_EDGE_M, GRAM_EDGE_D = (1, 7, 10_001), (1, 3, 1023, 2049), (1, 3, 8)
# the lower-tile Gram's edges: 1-row bands (N < 2112), 8-row bands, partial
# bands and tiles, N % 4 != 0 (the scalar-store variant), last 1024-column
# sweeps of one column (4097, 10001)
GRAM_LOWER_EDGE_N = (1, 7, 31, 32, 33, 255, 1003, 2047, 2048, 4097, 10_001)
GRAM_LOWER_EDGE_D = (1, 2, 5, 8)
# BASELINE config #4: benchmarks/bench_svgp_nuts.py's bench_nuts model (GPR,
# N=1000 on [0, 1], Y = sin(6 X) + 0.2 noise, RBF with LogNormal(0, 1) on the
# variance and LogNormal(-1, 1) on the lengthscale, LogNormal(-2, 1) on the
# noise), 8 chains of NUTS, max_depth 8, step size 0.1 to start, shared
# adaptation. The widths are bench_nuts's; the draws are cut from its 300
# warmup and 256 retained (tools/nuts_rate.py runs those)
NUTS_N, NUTS_CHAINS, NUTS_DEPTH = 1000, 8, 8
NUTS_WARMUP, NUTS_SAMPLES = 100, 64
NUTS_CHUNK = 50     # warmup transitions per nuts_warmup_window call (bench_nuts's BENCH_NUTS_CHUNK)
VMAP_TOL = 1e-6     # relative: the batched evaluation against a loop of per-chain autograd calls
VMAP_GRAD_TOL = 1e-5  # relative, max-norm: its gradient (f32 reductions in another order)
F64_TOL = 1e-10     # relative: the f64 plain path's log posterior against the f64 oracle
NOISE_MEDIAN = (0.01, 0.15)  # tests/test_mcmc.py's gate on the noise posterior's median
# GPMC (Bernoulli, RBF lengthscale 0.5, X on [-1, 1]) at the largest of these
# N whose use_kernels=False f32 factor of K + jitter I is finite
GPMC_NS = (1000, 750, 500, 250)
MCMC_JITTER = 1e-4  # the f32 jitter; the f64 references use it too
HMC_STEPS = 5       # HMC transitions of GPMC and SGPMC
HMC_EPS = {"GPMC": 1e-2, "SGPMC": 1e-4}  # SGPMC's N=10000 data terms steepen its latents' target
# phase 4g, the full-data variational slice: a log-Gaussian Cox process
# (VGP, Poisson) on a 64 x 32 grid over [0, 1]^2 and a 3-class MultiClass
# VGPOpperArchambeau on 2048 uniform points, both RBF(2, lengthscale 0.1),
# float32; N = 2048 is where the JAX package starts sending VGP's factor to
# its Pallas kernel (gpflow_slim_tpu/ops/linalg.py's _PALLAS_CHOL_MIN_N)
VGP_GRID = (64, 32)
VGP_N = VGP_GRID[0] * VGP_GRID[1]
VGP_LS = 0.1
VGP_NQ = 1024       # new points of the prediction requests
VGP_STEPS = 5       # Adam steps of training.fit, and L-BFGS steps of fit_lbfgs
VGP_LR = 1e-3       # Adam's learning rate: its first steps move each of q_sqrt's 2.1M entries by about this
VGP_JITTER = 1e-4   # config.default_jitter(float32); the f64 references use it too, to compute the same function
# phase 4h: BASELINE config #5 on one chip (GPRCG streaming with a deep kernel), GPRCG against
# the exact GPR, GPLVM/BayesianGPLVM (example 08's data), NKN (example 06's network)
CG_N = 50_000       # config #5's N: not cut
CG_PRECOND = 64     # pivoted-Cholesky rank of the N=10000 GPRCG
CG_REL = 0.02       # the SLQ estimate against the exact GPR (tests/test_iterative.py's Monte-Carlo tolerance)
CG_CMP_ITERS = 10   # CG iterations at which the preconditioned and plain residuals are compared
CG_PRED_ABS = 1e-5  # GPRCG's predictions: CG stops at a relative residual of 1e-6 on both routes
LVM_N, LVM_P, LVM_Q, LVM_M = 2048, 12, 2, 64
LVM_NQ = 1024
LVM_STEPS = 5
LVM_LR = 1e-2       # example 08's GPLVM rate; its BayesianGPLVM takes half
OA_N, OA_CLASSES = 2048, 3
FUNC_ROWS = 2       # rows of batched_value_and_grad over config #5's streaming model (fault m on the card)
# phase 4i: config #3 (bench_svgp_natgrad's data, the whitened SVGP) trained from disk through the
# data-parallel step on a 1-rank nccl world, checkpointed and resumed; GPR served from a checkpoint
DP_STEPS = 20       # disk-fed steps of make_svgp_step (Adam at SVGP_LR, minibatches of SVGP_B)
DP_RESUME_AT = 10   # the resume run's checkpoint
DP_PROFILED = 10    # steady disk-fed steps timed by the host's clock, and as many profiled
DP_SEED = 5         # the index generators' seeds
DP_REL = 1e-6       # dp_value_and_grad on the 1-rank world against one device; the resume gate where a step
                    # is not deterministic
# phase 4j: the distributed exact-GP paths on a 1-rank nccl world: config #5 through the distributed
# block-Cholesky at full width, bench.py's GPR through the other distributed paths on 1 x 1 meshes
DIST_N = 50_000     # config #5's N: not cut
DIST_BS = 250       # ops.blocked needs N a multiple of the block: 50000 is none of 256, 250 the nearest divisor
DIST_PANEL = 4096   # rows of a ring Gram panel (parallel.ring_gram.PANEL)
DIST_SMALL_BS = 250  # bench.py's N=10000 is no multiple of 256 either
GRID_BS = 125       # the cyclic and grid factors' block at N=10000 (80 blocks)
RING_MATVEC_TOL = 1e-4  # relative, max-norm: f32 sums of 10^4 products against f64
DIST_CHAIN_DRAWS = 5  # config #4's chains: warmup and draws, each
DIST_CHAIN_SEED = 4
# phase 4k: the Cholesky kernels' split-bf16 trailing-update modes (`syrk`), the JAX package's
# default arithmetic, held to that package's own hardware gates (tests/test_tpu_compiled.py:178-262)
SPLIT_MODES = ("s3", "s4", "s3d", "s4d")  # the split arithmetics; an "x2" name runs its base mode
SPLIT_FACTOR_MODES = ("hi", "s3", "s4", "s4d", "s4x2")  # the modes that test factors with
SPLIT_FACTOR_N, SPLIT_FACTOR_JITTER = 2048, 1e-2  # its RBF Gram (lengthscale 0.1) + 1e-2 I
SPLIT_FROB_TOL = 5e-4  # ||tril(L) - L64||_F / ||L64||_F, its gate
SPLIT_FUSED_N, SPLIT_FUSED_NOISE = 3000, 0.01  # its fused pipeline: RBF 0.1, noise 0.01
SPLIT_HLD_TOL, SPLIT_QUAD_TOL = 5e-6, 5e-5  # its gates on the half-logdet and quad, relative
# phase 3's sides for the split modes: last 256-wide panels of 64 and 192 columns, a last
# 128-tile of 64 columns (which has no second part)
SPLIT_SIDES = (320, 448, 2048, 2112)
# phase 3's check that each mode runs its own arithmetic: one trailing update over 3.5 and 4
# 128-tiles, each mode within SPLIT_APART_TOL (relative, max-norm) of its exact reference
SPLIT_APART_SIDES, SPLIT_APART_TOL = (704, 768), 1e-6
# the card's peaks for the bound of each kernel (vendor figures, H100 SXM)
F32_FLOPS = 67e12   # float32 without tensor cores
F64_TC_FLOPS = 67e12  # float64 on the tensor cores
F64_FLOPS = 33.5e12  # float64 without tensor cores
OPND_VJP_FLOP = 60   # float64 operations a lower pair of the operand's VJP: d^2, one exp, the multiply-adds
BF16_FLOPS = 989e12  # bf16 on the tensor cores, dense: the split modes' trailing products
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


def host_us(ms, device_ms):
    """The host's microseconds a call: the one-call time less the device
    time behind a spin, both from separate samples; None where the one-call
    time came out the smaller (a long call's spread, not a host time)."""
    return (ms - device_ms) * 1e3 if ms >= device_ms else None


def split_bound(syrk, Np, nbytes):
    """(ms, what bounds it) of a split-mode factorization of side Np: its
    trailing products, passes x Np^3 / 3 flop on the bf16 tensor cores,
    against ``nbytes`` over the memory rate."""
    passes = 4 if syrk.startswith("s4") else 3
    t_ops, t_bytes = passes * Np ** 3 / 3 / BF16_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tri_bytes(n):
    """Bytes of the lower triangle of an n x n float32 matrix."""
    return n * (n + 1) // 2 * 4


def oracle_objective(torch, X, Y, ls, var, noise, terms=False):
    """-log p(Y) of RBF + noise GPR in float64 on the card, written out
    independently of the port (bench.py's oracle formula); with ``terms``,
    ``(value, quad, logdet)``: Y^T K^-1 Y and log det K, of which it is
    half the sum plus N/2 log(2 pi)."""
    dev = torch.device("cuda")
    N = len(X)
    Xd = torch.tensor(X, dtype=torch.float64, device=dev) / ls
    Yd = torch.tensor(Y, dtype=torch.float64, device=dev)
    sq = (Xd**2).sum(1)[:, None] - 2 * Xd @ Xd.T + (Xd**2).sum(1)[None, :]
    Kd = var * torch.exp(-0.5 * torch.clamp(sq, min=0)) + noise * torch.eye(
        N, dtype=torch.float64, device=dev)
    Ld = torch.linalg.cholesky(Kd)
    al = torch.linalg.solve_triangular(Ld, Yd, upper=False)
    quad, logdet = float((al**2).sum()), 2 * float(torch.log(torch.diagonal(Ld)).sum())
    value = 0.5 * N * math.log(2 * math.pi) + 0.5 * logdet + 0.5 * quad
    return (value, quad, logdet) if terms else value


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


def gate(what, e_k, e_p, absolute, stock_factors=True):
    """The kernel route's error e_k within twice the use_kernels=False
    float32 route's e_p plus ``absolute``; prints both. ``stock_factors``
    False: the caller found that the stock route's float32 factor is not
    finite, and e_k is gated at ``absolute`` alone."""
    if not stock_factors:
        print(f"{what}: kernel route {e_k:.3e}, use_kernels=False f32 route {e_p} (it does not factor: gate "
              f"{absolute:g} against the f64 path alone)")
        e_p = 0.0
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


def check_gram_lower_edges(torch, gram, dev):
    """Phase 3 at the edges of the lower-tile Gram's bands, tiles and
    sweeps: every kind at each (N, D) of the grid against
    ``gram_lower_plain`` in f64 over every entry (the diagonal tiles'
    upper entries included), the strictly-upper 32 x 32 tiles exactly 0,
    one launch a call. Returns the max abs error (at variance 1.7, gated at
    1e-5 x variance)."""
    rng = np.random.RandomState(7)
    var, worst = 1.7, 0.0
    for D in GRAM_LOWER_EDGE_D:
        for n in GRAM_LOWER_EDGE_N:
            xs = torch.tensor(rng.uniform(0, 1, (n, D)) / 0.3, dtype=torch.float32, device=dev)
            t = torch.arange(n, device=dev) // gram.TILE
            upper_tiles = t[:, None] < t[None, :]
            for kind in gram.KINDS:
                before = gram.gram_lower_cuda.launches
                got = gram.gram_lower_cuda(kind, xs, torch.tensor(var, device=dev))
                launched = gram.gram_lower_cuda.launches - before
                err = float((got.double() - gram.gram_lower_plain(kind, xs.double(), var)).abs().max())
                upper_zero = bool((got[upper_tiles] == 0).all())
                worst = max(worst, err)
                if not (err <= OPERAND_TOL * var and upper_zero and launched == 1):
                    raise AssertionError(f"lower-tile Gram kernel disagrees at N={n} D={D} {kind}: max abs err "
                                         f"{err:.3e}, strictly-upper tiles 0: {upper_zero}, launches {launched}")
        print(f"gram_lower edges D={D}, N in {GRAM_LOWER_EDGE_N}, six kinds: max abs err {worst:.3e} (tol "
              f"{OPERAND_TOL:g} x variance {var}); strictly-upper tiles exactly 0; one launch a call")
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


def check_split_modes_apart(torch, _build, cholesky, dev):
    """Phase 3: which arithmetic each split mode's trailing update runs. One
    update alone (``gfs_chol_trailing_update``, the first panel's) on panel
    entries x = 2^e (1 + 3 2^-10 + 2^-18), e in {-1, 0}, whose split errs one
    way in every product (hi = 2^e, lo = 3 2^(e-10), a remainder "s4" drops),
    so the modes' updates part by ~6e-6 of the largest entry, ~40x the
    float32 rounding of a 256-term sum: each mode's update (strictly lower
    entries) within SPLIT_APART_TOL of its own exact reference, f64 sums of
    the split halves' products, and every other mode's reference more than
    3x that away; the f64 pivots the exact sums of squares."""
    lib = _build.load_library()
    panel = cholesky.PANEL
    worst = 0.0
    for Np in SPLIT_APART_SIDES:
        rng = np.random.RandomState(Np)
        X = 2.0 ** rng.randint(-1, 1, (Np - panel, panel)) * (1 + 3 * 2.0 ** -10 + 2.0 ** -18)
        C = rng.randint(-64, 65, (Np - panel, Np - panel)).astype(np.float64)
        Xd, Cd = torch.tensor(X, device=dev), torch.tensor(C, device=dev)
        lower = torch.tril(torch.ones(Np - panel, Np - panel, dtype=torch.bool, device=dev), -1)
        tiles = torch.arange(panel, Np, device=dev) // cholesky.TILE
        h, lo = cholesky.bf16_split(Xd)
        exact = Xd @ Xd.T
        refs = {"hi": Cd - exact}
        for syrk in SPLIT_MODES:
            P = h @ h.T + h @ lo.T + lo @ h.T + (lo @ lo.T if syrk.startswith("s4") else 0)
            if syrk.endswith("d"):
                P = torch.where(tiles[:, None] == tiles[None, :], exact, P)
            refs[syrk] = Cd - P
        refs = {m: r[lower] for m, r in refs.items()}
        piv = -(Xd ** 2).sum(1)
        for syrk in SPLIT_MODES:
            K = torch.zeros(Np, Np, dtype=torch.float32, device=dev)
            K[panel:, :panel], K[panel:, panel:] = Xd, Cd
            dpiv = torch.zeros(Np, dtype=torch.float64, device=dev)
            _build.check(lib, lib.gfs_chol_trailing_update(K.data_ptr(), Np, 0, dpiv.data_ptr(),
                                                           cholesky._mode_code(syrk), _build.stream_of(K)),
                         "chol_trailing_update")
            scale = float(refs[syrk].abs().max())
            own = float((K[panel:, panel:].double()[lower] - refs[syrk]).abs().max()) / scale
            apart = min(float((r - refs[syrk]).abs().max()) / scale for m, r in refs.items() if m != syrk)
            piv_ok = bool((dpiv[:panel] == 0).all()) and float((dpiv[panel:] - piv).abs().max()) <= 1e-13 * float(
                piv.abs().max())
            print(f"split trailing update syrk={syrk} Np={Np}: rel err against its own arithmetic {own:.3e} "
                  f"(tol {SPLIT_APART_TOL:g}), nearest other mode {apart:.3e} (must exceed {3 * SPLIT_APART_TOL:g}), "
                  f"f64 pivots exact: {piv_ok}")
            if not (own <= SPLIT_APART_TOL and apart > 3 * SPLIT_APART_TOL and piv_ok):
                raise AssertionError(f"the trailing update in {syrk} does not run its own arithmetic at Np={Np}")
            worst = max(worst, own)
    return worst


def check_split_kernels(torch, gram, cholesky, rng, dev):
    """Phase 3 for the split trailing-update modes: each of SPLIT_MODES, both
    Cholesky modes (fused at P = 1 and 7), at SPLIT_SIDES, against its plain
    split version (``cholesky_split_plain``) run in float64 on the same
    input, at the "hi" kernel's phase 3 gates. Returns the max abs errors."""
    errs = {"cholesky": 0.0, "chol_solve": 0.0}
    for Np in SPLIT_SIDES:
        n = Np - 7
        xs = torch.tensor(rng.uniform(0, 1, (n, 1)) / 0.2, dtype=torch.float32, device=dev)
        Kp = gram.gram_chol_operand_cuda("matern52", xs, 1.0, 0.5, Np)
        K64 = torch.tril(Kp).double()
        for syrk in SPLIT_MODES:
            L_ref = cholesky.cholesky_split_plain(K64, syrk)
            Lg = torch.tril(cholesky.cholesky_cuda(Kp.clone(), syrk))
            e = float((Lg.double() - L_ref).abs().max())
            worst = {"factor": e / float(L_ref.abs().max())}
            h_ref = float(torch.log(torch.diagonal(L_ref)).sum())
            worst["factor half_logdet"] = abs(float(torch.log(torch.diagonal(Lg).double()).sum()) - h_ref) / abs(h_ref)
            errs["cholesky"] = max(errs["cholesky"], e)
            pad_zero = True
            for P in (1, 7):
                Dp = torch.zeros(Np, P, dtype=torch.float32, device=dev)
                Dp[:n] = torch.tensor(rng.randn(n, P), dtype=torch.float32, device=dev)
                _, a_ref, h_ref = cholesky.cholesky_solve_split_plain(K64.clone(), Dp.double(), syrk)
                _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp, syrk)
                a_abs = float((a_got.double() - a_ref).abs().max())
                worst["half_logdet"] = max(worst.get("half_logdet", 0.0),
                                           abs(float(h_got) - float(h_ref)) / abs(float(h_ref)))
                worst["alpha"] = max(worst.get("alpha", 0.0), a_abs / float(a_ref.abs().max()))
                pad_zero = pad_zero and bool((a_got[n:] == 0).all())
                errs["chol_solve"] = max(errs["chol_solve"], a_abs)
            tols = {"factor": FACTOR_TOL, "factor half_logdet": FACTOR_HLD_TOL, "half_logdet": HLD_TOL,
                    "alpha": ALPHA_TOL}
            print(f"split syrk={syrk} Np={Np} (factor only; fused P = 1, 7) vs its plain version in f64: "
                  + ", ".join(f"{k} rel err {v:.3e} (tol {tols[k]:g})" for k, v in worst.items())
                  + f", pad rows of alpha exactly 0: {pad_zero}")
            if not (all(v <= tols[k] for k, v in worst.items()) and pad_zero):
                raise AssertionError(f"split mode {syrk} disagrees with its plain version at Np={Np}")
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
    _, counts = count_syncs(torch, dev, lambda: gft.training.natgrad_step(model, loss, SVGP_GAMMA))
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


def value_and_grads(gft, model, use_kernels, fn=lambda m: m.objective(), jitter=SPARSE_JITTER):
    """``fn(model)`` and the gradient of every trainable leaf
    (``params.trainable_leaves``: each Param's unconstrained value, and a
    DeepKernel's warp layer by layer) as f64 copies, on the route
    ``use_kernels`` picks, with the f32 jitter on every route."""
    with gft.config.temp_settings(use_kernels=use_kernels, jitter=jitter):
        model.zero_grad(set_to_none=True)
        loss = fn(model)
        loss.backward()
    return loss.item(), {n: t.grad.double() for n, t in gft.params.trainable_leaves(model)}


def gate_against_f64(what, k32, p32, ref64, stock_factors=True, zero=()):
    """Gate the kernel route's value and every gradient against the f64
    plain path, relative to the use_kernels=False f32 route's error (see
    ``gate`` for ``stock_factors``). ``zero``: leaves whose gradient is zero
    in exact arithmetic (a DeepKernel's last bias shifts every warped input
    alike, which a stationary kernel does not see): each must be zero to
    f64 rounding (ZERO_GRAD_REL of the largest gradient) on the f64 path,
    and its f32 errors, rounding over zero, are printed, not gated."""
    (vk, gk), (vp, gp), (v64, g64) = k32, p32, ref64
    print(f"{what}: kernel route {vk:.6f}, use_kernels=False {vp:.6f}, f64 plain path {v64:.6f}")
    gate(f"{what} rel err vs the f64 plain path", abs(vk - v64) / abs(v64), abs(vp - v64) / abs(v64),
         SPARSE_VALUE_ABS, stock_factors)
    top = max(float(w.abs().max()) for w in g64.values())
    for n, want in g64.items():
        if n in zero:
            size = float(want.abs().max())
            print(f"  grad {n} {tuple(want.shape)}: zero in exact arithmetic, f64 plain path {size:.3e} (at most "
                  f"{ZERO_GRAD_REL:g} x the largest gradient {top:.3e}); max abs, kernel route "
                  f"{float(gk[n].abs().max()):.3e}, use_kernels=False {float(gp[n].abs().max()):.3e} (not gated)")
            if not size <= ZERO_GRAD_REL * top:
                raise AssertionError(f"{what}: the gradient of {n} is not zero on the f64 plain path: {size:.3e}")
            continue
        scale = float(want.abs().max())
        gate(f"  grad {n} {tuple(want.shape)} rel err (max-norm)", float((gk[n] - want).abs().max()) / scale,
             float((gp[n] - want).abs().max()) / scale, SPARSE_GRAD_ABS, stock_factors)


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


def gate_predictions(what, got, plain, ref, stock_factors=True):
    """Each answer finite, and within twice the use_kernels=False f32
    route's error against the f64 plain path + SERVE_ABS (see ``gate`` for
    ``stock_factors``)."""
    for key, outs in got.items():
        names = ("mean", "var") if len(outs) == 2 else ("value",)
        for name, k_t, p_t, r_t in zip(names, outs, plain[key], ref[key]):
            if not bool(k_t.isfinite().all()):
                raise AssertionError(f"{what} {key} {name} is not finite")
            gate(f"{what} {key} {name} {tuple(k_t.shape)} max abs err vs the f64 plain path",
                 float((k_t.double() - r_t).abs().max()), float((p_t.double() - r_t).abs().max()), SERVE_ABS,
                 stock_factors)


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
    from torch.profiler (after one call outside the profile): one profile
    of PROFILES + 1 calls, each behind a spin kernel (``LEAD_IN_CYCLES``)
    that marks where it starts on the device timeline, and the most of each
    name over the calls after the first. A profile loses launches at its
    start now and then (the composite GPR's only cross Gram; OA's only
    cross Gram; the GPLVM's first three kernels in three separate
    profiles), so the first call is not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILES + 1):
            torch.cuda._sleep(LEAD_IN_CYCLES)
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and "Memcpy" not in e.name and "Memset" not in e.name
                     and "Command Buffer Full" not in e.name), key=lambda e: e.time_range.start)
    calls, cur = [], None
    for e in events:
        if "spin_kernel" in e.name:
            cur = collections.Counter()
            calls.append(cur)
        elif cur is not None:
            cur[e.name] += 1
    if len(calls) < PROFILES:
        raise RuntimeError(f"the profiler saw {len(calls)} of the {PROFILES + 1} marker kernels; its kernels: "
                           f"{sorted({e.name[:60] for e in events})[:12]}")
    most = collections.Counter()
    for c in calls[-PROFILES:]:
        most |= c
    return most


def busy_ms(events):
    """Length of the union of the events' intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def device_busy_ms(torch, fn):
    """The device's busy time of one call of fn (after one call outside the
    profile): the union of the intervals of the device activity that
    torch.profiler records over PROFILES calls, over PROFILES."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILES):
            fn()
        torch.cuda.synchronize()
    # "Command Buffer Full" marks host launches that waited on a full queue
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    return busy_ms(dev) / PROFILES


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
        print(f"  {name}: kernel {ms(r['ms'])} ms (runs of {RUN} {ms(r['run20_ms'])}, device {ms(r['device_ms'])}; "
              f"host {(r['ms'] - r['device_ms']) * 1e3:.2f} us a call), "
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


def nuts_data():
    """bench_nuts's data: RandomState(0), X uniform on [0, 1], Y = sin(6 X)
    + 0.2 noise."""
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (NUTS_N, 1)).astype(np.float32)
    Y = (np.sin(6 * X) + 0.2 * rng.randn(NUTS_N, 1)).astype(np.float32)
    return X, Y


def config4_model(gft, torch, dtype, dev):
    """bench_nuts's GPR with its priors, on the card."""
    X, Y = nuts_data()
    k = gft.kernels.RBF(1, lengthscales=0.3)
    k.variance = gft.params.Param(1.0, transform=gft.transforms.positive(), prior=gft.priors.LogNormal(0.0, 1.0),
                                  name="v")
    k.lengthscales = gft.params.Param(0.3, transform=gft.transforms.positive(),
                                      prior=gft.priors.LogNormal(-1.0, 1.0), name="l")
    m = gft.models.GPR(X, Y, kern=k, device=dev, dtype=dtype)
    m.likelihood.variance = gft.params.Param(0.05, transform=gft.transforms.positive(),
                                             prior=gft.priors.LogNormal(-2.0, 1.0), name="n")
    return m.to(device=dev, dtype=dtype)


def oracle_log_posterior(torch, u):
    """Config #4's log posterior at the unconstrained point ``u`` (a dict of
    floats by parameter name) in float64, written out independently of the
    port: the GPR log marginal likelihood (``oracle_objective``), each
    LogNormal(mu, 1) prior on the constrained value, and the log-Jacobian
    of softplus(u) + 1e-6. Returns ``(value, scale)``: ``scale`` =
    |Y^T K^-1 Y| + |log det K| + N, the size of the terms the value is a
    sum of, against which a float32 evaluation's error is measured."""
    X, Y = nuts_data()
    priors = {"kern.lengthscales.unconstrained": -1.0, "kern.variance.unconstrained": 0.0,
              "likelihood.variance.unconstrained": -2.0}
    softplus = lambda x: max(x, 0.0) + math.log1p(math.exp(-abs(x)))  # noqa: E731
    theta = {n: softplus(x) + 1e-6 for n, x in u.items()}
    nll, quad, logdet = oracle_objective(torch, X, Y, theta["kern.lengthscales.unconstrained"],
                                         theta["kern.variance.unconstrained"],
                                         theta["likelihood.variance.unconstrained"], terms=True)
    lp = -nll
    for n, mu in priors.items():
        lx = math.log(theta[n])
        lp += -0.5 * math.log(2 * math.pi) - 0.5 * (lx - mu) ** 2 - lx - softplus(-u[n])
    return lp, abs(quad) + abs(logdet) + len(X)


def load_vector(model, unpack, v):
    """Copy the flat unconstrained vector ``v`` into ``model``'s Params."""
    for n, t in unpack(v).items():
        model.get_parameter(n).data.copy_(t)


def count_syncs(torch, dev, fn):
    """``fn()`` under torch.cuda.set_sync_debug_mode("warn"), each host sync
    counted at the innermost line of the package on its stack, after a
    probe shows that the hook sees one known sync. Returns (fn's result,
    the counts)."""
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
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if probe != 1:
        raise AssertionError(f"the sync hook counted {probe} syncs for one .item()-like read, not 1")
    return out, counts


def windowed_warmup(gft, lp, z, gen, warmup, chunk=NUTS_CHUNK):
    """bench_nuts's warmup of the chains ``z`` (C, D): Stan's windows
    (``warmup_schedule``), each driven in chunks of at most ``chunk``
    transitions through ``nuts_warmup_window`` with shared adaptation from
    step size 0.1, each slow window closed by ``nuts_slow_window_close``.
    Returns ``(z, step_size, inv_mass)`` for sampling."""
    da, _, inv_mass = gft.mcmc.nuts_warmup_init(z, step_size=0.1)
    for phase, span in gft.mcmc.warmup_schedule(warmup):
        _, w, _ = gft.mcmc.nuts_warmup_init(z)
        for lo in range(0, span, chunk):
            z, da, w, inv_mass = gft.mcmc.nuts_warmup_window(lp, z, gen, min(chunk, span - lo), da, w, inv_mass,
                                                             max_depth=NUTS_DEPTH, shared_adaptation=True)
        if phase == "slow":
            da, inv_mass = gft.mcmc.nuts_slow_window_close(da, w, shared_adaptation=True)
    return z, da.log_step_avg.exp(), inv_mass


def mcmc_checks(gft, torch, gram, cholesky, dev):
    """Phase 4f: BASELINE config #4 at full width (N=1000, 8 chains, f32,
    the kernel route). The batched log posterior and gradient of 8 dispersed
    unconstrained vectors against an f64 oracle and the f64 plain path, and
    against a loop of per-chain autograd calls; their launches, and a
    profiler launch check of the batched forward; a leaf whose covariance
    does not factor in f32 diverges; then a short NUTS run (Stan-windowed
    warmup in chunks, then sampling with the launch counters set to 0, the
    host syncs counted). Returns the sampling run's launches."""
    from gpflow_slim_tpu_torch.mcmc import base as mcmc_base

    nuts_mod = sys.modules["gpflow_slim_tpu_torch.mcmc.nuts"]
    C = NUTS_CHAINS
    model = config4_model(gft, torch, torch.float32, dev)
    lp, x0, unpack = gft.mcmc.model_logprob(model)
    names = list(unpack(x0))
    fn = mcmc_base.batched_value_and_grad(lp)
    zs = x0[None] + torch.tensor(0.5 * np.random.RandomState(11).randn(C, x0.numel()), dtype=torch.float32,
                                 device=dev)

    # the batched evaluation: once per chain on each kernel
    gram.gram_chol_operand_cuda.launches = cholesky.cholesky_solve_cuda.launches = 0
    lps, gs = fn(zs)
    torch.cuda.synchronize()
    launches = (gram.gram_chol_operand_cuda.launches, cholesky.cholesky_solve_cuda.launches)
    print(f"config #4 batched log posterior + gradient of {C} chains (kernel route): launches operand "
          f"{launches[0]}, chol_solve {launches[1]}")
    if launches != (C, C):
        raise AssertionError(f"the batched evaluation did not launch each kernel once per chain: {launches}")
    # the log posterior is a sum of terms far larger than itself (at N=1000,
    # noise 0.05: Y^T K^-1 Y ~ 1e3, log det K ~ -3e3, N log(2 pi) / 2, against
    # values of -2 to 200), so float32's error is measured against their
    # size, |quad| + |logdet| + N, and held to bench.py's 1e-5; the f64
    # plain path must give the oracle's value to 1e-10 of the value itself
    with gft.config.temp_settings(use_kernels=False):
        lps_stock, gs_stock = fn(zs)
    oracle = [oracle_log_posterior(torch, dict(zip(names, z.double().tolist()))) for z in zs]
    want = torch.tensor([v for v, _ in oracle], dtype=torch.float64, device=dev)
    scale = torch.tensor([sc for _, sc in oracle], dtype=torch.float64, device=dev)
    m64 = config4_model(gft, torch, torch.float64, dev)
    lp64, _, _ = gft.mcmc.model_logprob(m64)
    lps64, gs64 = mcmc_base.batched_value_and_grad(lp64)(zs.double())
    rel64 = float(((lps64 - want).abs() / want.abs()).max())
    rel = lambda a: float(((a.double() - want).abs() / scale).max())  # noqa: E731
    print(f"  log posterior values {[round(float(v), 3) for v in lps]}; the terms' size |quad| + |logdet| + N "
          f"{[round(float(v), 1) for v in scale]}")
    print(f"  f64 plain path vs the f64 oracle: rel err {rel64:.3e} (gate {F64_TOL:g}); f32 error over the terms' "
          f"size: kernel route {rel(lps):.3e}, use_kernels=False {rel(lps_stock):.3e} (gate {OBJECTIVE_TOL:g})")
    if not (rel64 <= F64_TOL and rel(lps) <= OBJECTIVE_TOL):
        raise AssertionError("config #4's log posterior disagrees with the f64 oracle")
    grel = lambda a: float(((a.double() - gs64).abs().amax(1) / gs64.abs().amax(1)).max())  # noqa: E731
    print(f"  gradient rel err (max-norm) vs the f64 plain path, max over chains: kernel route {grel(gs):.3e}, "
          f"use_kernels=False {grel(gs_stock):.3e} (gate {GRAD_TOL:g})")
    if not grel(gs) <= GRAD_TOL:
        raise AssertionError("config #4's gradient disagrees with the f64 plain path")
    # the batched evaluation against a loop of per-chain autograd calls on
    # the same route (each factors in place, outside any transform): the
    # same log posterior to 1e-6; the gradients differ by the float32
    # rounding of the reductions that vmap's batched operators add in
    # another order (2.7e-6 measured on the H100), held to VMAP_GRAD_TOL
    loop_lp = loop_g = 0.0
    for c in range(C):
        load_vector(model, unpack, zs[c])
        model.zero_grad(set_to_none=True)
        v = model.log_posterior()
        v.backward()
        g = torch.cat([model.get_parameter(n).grad.reshape(-1) for n in names])
        loop_lp = max(loop_lp, abs(float(lps[c]) - v.item()) / abs(v.item()))
        loop_g = max(loop_g, float((gs[c] - g).abs().max() / g.abs().max()))
    load_vector(model, unpack, x0)
    print(f"  batched vs a per-chain autograd loop: log posterior rel err {loop_lp:.3e} (gate {VMAP_TOL:g}), "
          f"gradient rel err (max-norm) {loop_g:.3e} (gate {VMAP_GRAD_TOL:g})")
    if not (loop_lp <= VMAP_TOL and loop_g <= VMAP_GRAD_TOL):
        raise AssertionError("the batched evaluation disagrees with the per-chain loop")

    # the profiler: the batched forward runs the operand and the fused
    # Cholesky once per chain, and no library factorization or solve
    def forward():
        with torch.no_grad():
            torch.func.vmap(lp)(zs)

    names_k = device_kernels(torch, forward)
    mine = collections.Counter()
    for n, c in names_k.items():
        if ours(n):
            mine[ours(n)] += c
    libs = library_solves(names_k)
    print(f"launch check, config #4 batched forward of {C} chains (torch.profiler): {dict(mine)}; library "
          f"factorizations and triangular solves: {libs or 'none'}")
    if mine.get("gram_chol_operand_kernel") != C or mine.get("logdet_sum_kernel") != C or libs:
        raise AssertionError("the batched forward did not run the operand and the fused Cholesky once per "
                             "chain, or ran a library solve")

    # a leaf onto a point whose covariance does not factor in f32 (noise at
    # its floor of 1e-6, lengthscale ~3): its NaN must make the leaf diverge
    bad = x0.clone()
    bad[names.index("kern.lengthscales.unconstrained")] = 3.0
    bad[names.index("likelihood.variance.unconstrained")] = -30.0
    lp_bad = float(fn(bad[None])[0][0])
    with gft.config.temp_settings(use_kernels=False):
        lp_bad_stock = float(fn(bad[None])[0][0])
    z0 = x0[None]
    lp0, g0 = fn(z0)
    r0 = (bad[None] - z0) - 0.5 * g0  # one leapfrog of step 1 from z0 lands on bad
    ones = torch.ones_like(z0)
    sub = nuts_mod._build_subtree(fn, z0, r0, g0, 0, ones[:, 0], ones[:, 0], ones,
                                  lp0 - mcmc_base.kinetic_energy(r0, ones), torch.Generator(device=dev))
    print(f"non-PD leaf (noise 1e-6, lengthscale {math.log1p(math.exp(3.0)):.3f}): log posterior kernel route "
          f"{lp_bad}, use_kernels=False {lp_bad_stock}; the leaf: diverging {bool(sub.diverging[0])}, "
          f"log weight {float(sub.log_weight[0])}, accept {float(sub.sum_accept[0])}")
    if not (bool(sub.diverging[0]) and float(sub.sum_accept[0]) == 0.0 and math.isinf(float(sub.log_weight[0]))):
        raise AssertionError("a leaf at a point that does not factor did not count as a divergence")

    # a short NUTS run at full width: warmup window by window, in chunks
    # of at most 50 transitions, then sampling with counts set to 0
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    z, eps, inv_mass = windowed_warmup(gft, lp, x0[None].repeat(C, 1), gen, NUTS_WARMUP)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = [0]

    def counted(v):
        calls[0] += 1  # once per batched evaluation: vmap calls it with the batch
        return lp(v)

    def sample():
        return gft.mcmc.nuts(counted, z, gen, NUTS_SAMPLES, num_warmup=0, step_size=eps, inv_mass=inv_mass,
                             max_depth=NUTS_DEPTH)

    gram.gram_chol_operand_cuda.launches = cholesky.cholesky_solve_cuda.launches = 0
    t0 = time.perf_counter()
    (samples, info), syncs = count_syncs(torch, dev, sample)
    sample_s = time.perf_counter() - t0
    run_launches = {"operand": gram.gram_chol_operand_cuda.launches,
                    "chol_solve": cholesky.cholesky_solve_cuda.launches}
    chain_leaves = int(info["num_leaves"].sum())
    leaf_steps = calls[0] - 1  # the first call is the start's evaluation
    s = samples.double().cpu().numpy()
    noise = model.likelihood.variance.transform.forward(samples[..., names.index("likelihood.variance.unconstrained")])
    rhat = gft.mcmc.potential_scale_reduction(s)
    ess = gft.mcmc.effective_sample_size(s)
    nuts_line = {
        "draws_per_s": C * NUTS_SAMPLES / sample_s, "grad_evals_per_s": (chain_leaves + C) / sample_s,
        "mean_depth": float(info["depth"].double().mean()), "step_size": float(eps[0]),
        "mean_accept": float(info["accept_prob"].double().mean()), "rhat_max": float(rhat.max()),
        "min_ess": float(ess.min()), "leaf_steps": leaf_steps, "chain_leaves": chain_leaves,
        "syncs": sum(syncs.values()), "syncs_per_leaf": sum(syncs.values()) / leaf_steps,
        "launches_per_leaf": run_launches["operand"] / leaf_steps, "ms_per_leaf": sample_s / leaf_steps * 1e3,
        "warmup_s": warm_s, "sample_s": sample_s}
    print(f"NUTS, config #4 ({C} chains, N={NUTS_N}, max_depth {NUTS_DEPTH}, shared adaptation; warmup "
          f"{NUTS_WARMUP} in Stan windows, {warm_s:.1f} s; {NUTS_SAMPLES} draws, {sample_s:.2f} s with the sync "
          f"hook on): {json.dumps(nuts_line)}")
    print(f"  host syncs in the sampling run by package line: {dict(syncs)}; launches {run_launches}; noise "
          f"median {float(noise.median()):.4f} (gate {NOISE_MEDIAN})")
    if not np.isfinite(s).all() or bool(info["diverging"].any()):
        raise AssertionError("NUTS drew a non-finite value or diverged after warmup")
    if not NOISE_MEDIAN[0] < float(noise.median()) < NOISE_MEDIAN[1]:
        raise AssertionError("the noise posterior's median is off")
    if run_launches != {"operand": chain_leaves + C, "chol_solve": chain_leaves + C}:
        raise AssertionError(f"the kernels did not launch once per active chain per leaf ({chain_leaves} chain "
                             f"leaves + {C} starts): {run_launches}")
    elsewhere = {k: n for k, n in syncs.items() if not k.startswith("gpflow_slim_tpu_torch/mcmc/nuts.py")}
    if elsewhere or nuts_line["syncs"] > leaf_steps:
        raise AssertionError(f"host syncs: {nuts_line['syncs']} for {leaf_steps} leaves; outside the sampler's "
                             f"loop: {elsewhere}")

    # one batched evaluation of the 8 chains, kernel route against stock
    def routed(flag):
        def run():
            with gft.config.temp_settings(use_kernels=flag):
                fn(zs)
        return run

    leaf_ms, leaf_plain_ms = paired_ms(torch, routed(True), routed(False))
    print(f"  one batched log posterior + gradient of {C} chains (median of {2 * REPS}, CUDA events): kernels "
          f"{leaf_ms:.3f} ms, use_kernels=False {leaf_plain_ms:.3f} ms")
    return run_launches


def gpmc_data(n):
    """tests/test_mcmc.py's GPMC data at n points: X uniform on [-1, 1],
    Y = (sin(3 X) > 0)."""
    rng = np.random.RandomState(1)
    X = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    return X, (np.sin(3 * X) > 0).astype(np.float32)


def mc_model(gft, torch, cls, dtype, dev, n=None):
    """GPMC at ``n`` points, or SGPMC on config #2's X and Z with labels
    (Y > 0) and its kernel; Bernoulli."""
    if cls == "GPMC":
        X, Y = gpmc_data(n)
        return gft.models.GPMC(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.5),
                               likelihood=gft.likelihoods.Bernoulli(), device=dev, dtype=dtype)
    X, Y, Z = sparse_data()
    return gft.models.SGPMC(X, (Y > 0).astype(np.float32), kern=sparse_kern(gft),
                            likelihood=gft.likelihoods.Bernoulli(), Z=Z, device=dev, dtype=dtype)


def mc_checks(gft, torch, gram, cholesky, trsm, dev):
    """Phase 4f for GPMC and SGPMC: the batched log posterior and gradient
    of 8 dispersed vectors on the kernel route against the f64 plain path,
    within twice the use_kernels=False f32 route's error + 1e-5 / 1e-3 (the
    SVGP phase's form); HMC_STEPS HMC transitions of 8 chains, finite; a
    profiler launch check of the batched evaluation and of predict_f.
    Returns GPMC's N and the launches of each model's HMC run."""
    from gpflow_slim_tpu_torch.mcmc import base as mcmc_base

    n_gpmc = None
    for n in GPMC_NS:
        X, _ = gpmc_data(n)
        with gft.config.temp_settings(use_kernels=False), torch.no_grad():
            Xt = torch.tensor(X, device=dev)
            K = gft.kernels.RBF(1, lengthscales=0.5).to(dev, torch.float32).K(Xt)
            finite = bool(torch.isfinite(gft.ops.linalg.cholesky(K + MCMC_JITTER * torch.eye(n, device=dev))).all())
        print(f"GPMC: use_kernels=False f32 factor of K + {MCMC_JITTER:g} I at N={n}: finite {finite}")
        if finite:
            n_gpmc = n
            break
    if n_gpmc is None:
        raise AssertionError("no GPMC size factors in f32")
    launches, rng = {}, np.random.RandomState(12)
    for cls in ("GPMC", "SGPMC"):
        m32 = mc_model(gft, torch, cls, torch.float32, dev, n_gpmc)
        m64 = mc_model(gft, torch, cls, torch.float64, dev, n_gpmc)
        lp, x0, unpack = gft.mcmc.model_logprob(m32)
        lp64, _, _ = gft.mcmc.model_logprob(m64)
        # dispersed vectors: latents N(0, 0.5^2), hyperparameters +- 0.1, Z kept
        scale = torch.cat([torch.full((t.numel(),), 0.0 if n == "feature.Z.unconstrained" else
                                      0.5 if n == "V.unconstrained" else 0.1) for n, t in unpack(x0).items()])
        zs = x0[None] + scale.to(dev) * torch.tensor(rng.randn(NUTS_CHAINS, x0.numel()), dtype=torch.float32,
                                                     device=dev)
        fn = mcmc_base.batched_value_and_grad(lp)
        with gft.config.temp_settings(jitter=MCMC_JITTER):
            (lk, gk) = fn(zs)
            with gft.config.temp_settings(use_kernels=False):
                (lpl, gpl) = fn(zs)
            l64, g64 = mcmc_base.batched_value_and_grad(lp64)(zs.double())
        rel = lambda a: float(((a.double() - l64).abs() / l64.abs()).max())  # noqa: E731
        grel = lambda a: float(((a.double() - g64).abs().amax(1) / g64.abs().amax(1)).max())  # noqa: E731
        if not (torch.isfinite(lk).all() and torch.isfinite(gk).all()):
            raise AssertionError(f"{cls}: the kernel route's batched log posterior or gradient is not finite")
        gate(f"{cls} batched log posterior ({NUTS_CHAINS} chains, {x0.numel()} dims) rel err vs the f64 plain "
             "path", rel(lk), rel(lpl), OBJECTIVE_TOL)
        gate(f"{cls} batched gradient rel err (max-norm) vs the f64 plain path", grel(gk), grel(gpl), GRAD_TOL)
        reset_counts(gram, cholesky, trsm)
        gen = torch.Generator(device=dev).manual_seed(1)
        with gft.config.temp_settings(jitter=MCMC_JITTER):
            samples, info = gft.mcmc.hmc(lp, zs, gen, HMC_STEPS, epsilon=HMC_EPS[cls], lmin=3, lmax=6)
        torch.cuda.synchronize()
        launches[cls] = read_counts(gram, cholesky, trsm)
        print(f"{cls}: {HMC_STEPS} HMC transitions of {NUTS_CHAINS} chains: "
              f"finite {bool(torch.isfinite(samples).all())}"
              f", accept rate {float(info['accept_rate'].mean()):.3f}; launches {launches[cls]}")
        if not bool(torch.isfinite(samples).all()):
            raise AssertionError(f"{cls}: HMC drew a non-finite value")
        # the profiler: the batched evaluation, then predict_f at the last draw
        load_vector(m32, unpack, samples[0, -1])

        def evaluate():
            with gft.config.temp_settings(jitter=MCMC_JITTER):
                fn(zs)

        def predict():
            with gft.config.temp_settings(jitter=MCMC_JITTER), torch.no_grad():
                m32.predict_f(torch.linspace(-1, 1, 257, device=dev)[:, None])

        for label, f in (("batched log posterior + gradient", evaluate), ("predict_f", predict)):
            names_k = device_kernels(torch, f)
            mine = collections.Counter()
            for n, c in names_k.items():
                if ours(n):
                    mine[ours(n)] += c
            libs = library_solves(names_k)
            launches[f"{cls} {label}"] = dict(mine)
            print(f"launch check, {cls} {label} (torch.profiler, kernel route): {dict(mine)}; library "
                  f"factorizations and triangular solves: {libs or 'none'}")
            if libs:
                raise AssertionError(f"{cls} {label} ran a library factorization or solve: {libs}")
    # by the table of PERF.md: 3 the factor-only Cholesky, 4 the cross Gram,
    # 6 the lower-tile Gram, 7 the TRSM (predict_f), 8 the batched TRSM (a
    # batch of chains' solves, by the TRSM Function's vmap rule)
    found = set().union(*(set(v) for k, v in launches.items() if " " in k))
    need = {3: ("chol_diag_kernel",), 4: ("gram_cross_kernel",), 6: ("gram_lower_kernel",),
            7: ("trsm_thin_kernel", "trsm_group_kernel"), 8: ("batched_trsm_kernel",)}
    missing = [k for k, names in need.items() if not found & set(names)]
    print(f"GPMC and SGPMC ran kernels {sorted(set(need) - set(missing))} of the table")
    if missing:
        raise AssertionError(f"GPMC and SGPMC did not run kernels {missing} of the table")
    return n_gpmc, launches


def nuts_times(torch, gram, cholesky, dev):
    """Phase 5 for config #4: the operand at N=1000 padded to 1024 and the
    fused Cholesky at Np=1024 (one chain's launch at a leaf), each held
    against its plain version in float64 at phase 3's tolerances on the
    config's own operand (lengthscale 0.3, variance 1, noise 0.05) and
    timed against it in float32. Returns their rows of the kernels line,
    each with its ``max_abs_err``."""
    X, Y = nuts_data()
    Np = NUTS_N + (-NUTS_N) % cholesky.BLOCK
    xs = (torch.tensor(X, device=dev) / 0.3).contiguous()
    var, noise = torch.tensor(1.0, device=dev), torch.tensor(0.05, device=dev)
    opnd = lambda: gram.gram_chol_operand_cuda("rbf", xs, var, noise, Np)  # noqa: E731
    Kp = opnd()
    lower = torch.ones(Np, Np, dtype=torch.bool, device=dev).tril_()
    op_err = float((Kp.double() - gram.gram_chol_operand_plain("rbf", xs.double(), 1.0, 0.05, Np))[lower].abs().max())
    Dp = torch.zeros(Np, 1, device=dev)
    Dp[:NUTS_N] = torch.tensor(Y, device=dev)
    _, a_ref, h_ref = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
    _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
    torch.cuda.synchronize()
    h_rel = abs(float(h_got) - float(h_ref)) / abs(float(h_ref))
    a_abs = float((a_got.double() - a_ref).abs().max())
    a_rel = a_abs / float(a_ref.abs().max())
    print(f"config #4 operand (N={NUTS_N}, Np={Np}, noise 0.05): max abs err {op_err:.3e} (tol {OPERAND_TOL:g} x "
          f"variance); chol_solve on it: half_logdet rel err {h_rel:.3e} (tol {HLD_TOL:g}), alpha rel err "
          f"{a_rel:.3e} (tol {ALPHA_TOL:g})")
    if not (op_err <= OPERAND_TOL and h_rel <= HLD_TOL and a_rel <= ALPHA_TOL):
        raise AssertionError("a kernel disagrees with its plain version at config #4's shapes")
    k_ms, p_ms = paired_ms(torch, opnd, lambda: gram.gram_chol_operand_plain("rbf", xs, var, noise, Np))
    b_ms, b_by = bound(5 * Np * (Np + 1) // 2, tri_bytes(Np) + NUTS_N * 4)
    rows = {"gram_chol_operand_nuts": {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                                       "bound_by": b_by, "max_abs_err": op_err, **other_ms(torch, opnd)}}
    chol = lambda K: cholesky.cholesky_solve_cuda(K, Dp)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, chol, lambda K: cholesky.cholesky_solve_plain(K, Dp), setup=lambda: (Kp.clone(),))
    b_ms, b_by = bound(Np ** 3 / 3 + 2 * Np ** 2, 2 * tri_bytes(Np) + 2 * Np * 4)
    rows["chol_solve_logdet_nuts"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                                      "bound_by": b_by, "max_abs_err": a_abs,
                                      **other_ms(torch, chol, setup=lambda: (Kp.clone(),))}
    for name, r in rows.items():
        print(f"  {name} (Np={Np}): kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), plain f32 "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return rows


def gpmc_lower_times(torch, gram, n, dev):
    """Phase 5 for GPMC: the lower-tile Gram at its N (RBF, lengthscale
    0.5, D=1; 1-row bands below N = 2112), held against its plain version
    in float64 at phase 3's tolerance and timed against it in float32.
    Returns its row of the kernels line, with its ``max_abs_err``."""
    X, _ = gpmc_data(n)
    xs = (torch.tensor(X, device=dev) / 0.5).contiguous()
    var = torch.tensor(1.0, device=dev)
    kernel = lambda: gram.gram_lower_cuda("rbf", xs, var)  # noqa: E731
    err = float((kernel().double() - gram.gram_lower_plain("rbf", xs.double(), 1.0)).abs().max())
    print(f"GPMC lower-tile Gram (N={n}): max abs err {err:.3e} (tol {OPERAND_TOL:g} x variance)")
    if not err <= OPERAND_TOL:
        raise AssertionError("the lower-tile Gram kernel disagrees with its plain version at GPMC's shape")
    k_ms, p_ms = paired_ms(torch, kernel, lambda: gram.gram_lower_plain("rbf", xs, var))
    b_ms, b_by = bound(5 * n * (n + 1) // 2, n * n * 4 + n * 4)
    row = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, **other_ms(torch, kernel)}
    print(f"  gram_lower_gpmc (N={n}): kernel {k_ms:.4f} ms (runs of {RUN} {row['run20_ms']:.4f}, device "
          f"{row['device_ms']:.4f}; host {(k_ms - row['device_ms']) * 1e3:.2f} us a call), plain f32 {p_ms:.4f} "
          f"ms, bound {b_ms:.6f} ms ({b_by})")
    return row


@functools.lru_cache(maxsize=None)
def vgp_data():
    """Phase 4g's log-Gaussian Cox process: a 64 x 32 grid over [0, 1]^2
    (N = 2048 cells), f drawn from RBF(2, lengthscales=0.1, variance=1) in
    float64 with RandomState(0), Y ~ Poisson(exp(f)); and VGP_NQ new points
    uniform on [0, 1]^2. float32 arrays (the float64 models take the same
    values)."""
    rng = np.random.RandomState(0)
    gx, gy = np.meshgrid(np.linspace(0, 1, VGP_GRID[0]), np.linspace(0, 1, VGP_GRID[1]), indexing="ij")
    X = np.stack([gx.ravel(), gy.ravel()], 1)
    f = rbf_draws(X, VGP_LS, 1, rng)
    Y = rng.poisson(np.exp(f)).astype(np.float64)
    Xq = rng.uniform(0, 1, (VGP_NQ, 2))
    return X.astype(np.float32), Y.astype(np.float32), Xq.astype(np.float32)


@functools.lru_cache(maxsize=None)
def oa_data():
    """Phase 4g's classification data: N = 2048 points uniform on [0, 1]^2
    (RandomState(1)), labelled by the argmax of OA_CLASSES float64 draws
    from RBF(2, 0.1); and VGP_NQ new points."""
    rng = np.random.RandomState(1)
    X = rng.uniform(0, 1, (OA_N, 2))
    Y = np.argmax(rbf_draws(X, VGP_LS, OA_CLASSES, rng), 1)[:, None].astype(np.float64)
    Xq = rng.uniform(0, 1, (VGP_NQ, 2))
    return X.astype(np.float32), Y.astype(np.float32), Xq.astype(np.float32)


def rbf_draws(X, ls, k, rng):
    """k draws of f ~ GP(0, RBF(ls, variance 1)) at X, in float64 on the host
    (jitter 1e-6 for the draw alone)."""
    d2 = np.sum(np.square(X[:, None, :] - X[None, :, :]), -1)
    K = np.exp(-0.5 * d2 / ls ** 2) + 1e-6 * np.eye(len(X))
    return np.linalg.cholesky(K) @ rng.randn(len(X), k)


def vgp_model(gft, torch, which, dtype, dev, like=None):
    """Phase 4g's ``"VGP"`` (Poisson, the grid) or ``"OA"`` (a 3-class
    MultiClass VGPOpperArchambeau) on ``dev``; ``like``: a model whose
    unconstrained values it takes."""
    kern = gft.kernels.RBF(2, lengthscales=VGP_LS)
    if which == "VGP":
        X, Y, _ = vgp_data()
        model = gft.models.VGP(X, Y, kern=kern, likelihood=gft.likelihoods.Poisson(), device=dev, dtype=dtype)
    else:
        X, Y, _ = oa_data()
        model = gft.models.VGPOpperArchambeau(X, Y, kern=kern, likelihood=gft.likelihoods.MultiClass(OA_CLASSES),
                                              num_latent=OA_CLASSES, device=dev, dtype=dtype)
    if like is not None:
        gft.interop.load_unconstrained(model, {
            n: p.unconstrained.detach().cpu().numpy() for n, p in gft.params.parameters(like)})
    return model


def check_vgp_kernels(gft, torch, gram, cholesky, trsm, dev):
    """Phase 4g's kernels at the slice's shapes, against their plain
    versions in float64: the lower-tile Gram of the grid (N=2048, D=2); the
    cross Gram of the grid and of OA's points against themselves (2048 x
    2048) and against the new points (2048 x VGP_NQ); the factor-only
    Cholesky of K + 1e-4 I (Np=2048); the wide TRSM on that factor at
    P=2048 (the Cholesky VJP's solves), lower and upper through the
    transposed view; and the operand and the fused Cholesky on entry()'s
    GPR (N=2048, its initial hyperparameters) at phase 3's tolerances. The
    factor and the TRSM are gated at twice cuSOLVER's / cuBLAS's f32 error
    plus their fixed gates (K's f32 conditioning sets both); both Cholesky
    modes' half-logdets at three jitters (``logdet_gates``). Prints cond(K
    + 1e-4 I) in float64 and whether the stock f32 factor is finite.
    Returns the max abs errors, the factor and whether the stock factor is
    finite."""
    X, _, _ = vgp_data()
    xs = (torch.tensor(X, device=dev) / VGP_LS).contiguous()
    one = torch.tensor(1.0, device=dev)
    K = gram.gram_lower_cuda("rbf", xs, one)
    e_gram = float((K.double() - gram.gram_lower_plain("rbf", xs.double(), 1.0)).abs().max())
    print(f"gram (lower tiles) of the VGP grid (N={VGP_N}, D=2): max abs err {e_gram:.3e} (tol {OPERAND_TOL:g} x "
          f"variance 1)")
    if not e_gram <= OPERAND_TOL:
        raise AssertionError("the lower-tile Gram disagrees at the VGP's shape")
    e_cross = 0.0
    for what, (Xa, _, Xq) in (("VGP grid", vgp_data()), ("OA points", oa_data())):
        xa = (torch.tensor(Xa, device=dev) / VGP_LS).contiguous()
        for x2 in (xa, (torch.tensor(Xq, device=dev) / VGP_LS).contiguous()):
            err = float((gram.gram_cuda("rbf", xa, x2, one).double()
                         - gram.gram_reference("rbf", xa.double(), x2.double(), 1.0)).abs().max())
            print(f"gram (cross) of the {what} ({len(xa)} x {len(x2)}, D=2): max abs err {err:.3e} "
                  f"(tol {OPERAND_TOL:g} x variance 1)")
            if not err <= OPERAND_TOL:
                raise AssertionError(f"the cross Gram disagrees at the {what}' {len(xa)} x {len(x2)}")
            e_cross = max(e_cross, err)
    logdet_gates(torch, cholesky, K, dev)
    K.diagonal().add_(VGP_JITTER)
    K64 = torch.tril(K).double()  # the kernels' input, in float64: the plain version's
    ev = torch.linalg.eigvalsh(K64, UPLO="L")
    L_ref = cholesky.cholesky_plain(K64)
    del K64
    L_lib = cholesky.cholesky_plain(torch.tril(K))  # cuSOLVER in f32
    stock_finite = bool(torch.isfinite(L_lib).all())
    print(f"K + {VGP_JITTER:g} I of the VGP grid: cond {float(ev[-1] / ev[0]):.4e} in float64 (eigenvalues "
          f"{float(ev[0]):.4e} .. {float(ev[-1]):.4e}); the stock f32 factor (cuSOLVER) is finite: {stock_finite}")
    L = torch.tril(cholesky.cholesky_cuda(K.clone()))
    e_fac = float((L.double() - L_ref).abs().max())
    scale = float(L_ref.abs().max())
    gate(f"cholesky (factor only) at Np={VGP_N}: factor rel err vs f64", e_fac / scale,
         float((L_lib.double() - L_ref).abs().max()) / scale, FACTOR_TOL, stock_finite)
    Ld = L.double()
    B = torch.tensor(np.random.RandomState(12).randn(VGP_N, VGP_N), dtype=torch.float32, device=dev)
    e_trsm = 0.0
    for name, T, Td, lo in (("lower", L, Ld, True), ("upper, L.T view", L.T, Ld.T, False)):
        want = torch.linalg.solve_triangular(Td, B.double(), upper=not lo)
        err = float((trsm.trsm_cuda(T, B, lo).double() - want).abs().max())
        lib = float((torch.linalg.solve_triangular(T, B, upper=not lo).double() - want).abs().max())
        gate(f"trsm {name} N={VGP_N} P={VGP_N} ({trsm.trsm_schedule(VGP_N)}) on the VGP factor: rel err (max-norm)",
             err / float(want.abs().max()), lib / float(want.abs().max()), TRSM_TOL, stock_finite)
        e_trsm = max(e_trsm, err)
    del L_ref, L_lib, Ld, B
    # entry()'s GPR: the operand and the fused Cholesky at its N=2048
    xs, var, noise, Dp, Np = entry_operands(gft, torch, cholesky, dev)
    Kp = gram.gram_chol_operand_cuda("rbf", xs, var, noise, Np)
    lower = torch.ones(Np, Np, dtype=torch.bool, device=dev).tril_()
    e_opnd = float((Kp.double() - gram.gram_chol_operand_plain("rbf", xs.double(), float(var), float(noise), Np))
                   [lower].abs().max())
    _, a_ref, h_ref = cholesky.cholesky_solve_plain(torch.tril(Kp).double(), Dp.double())
    _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp)
    torch.cuda.synchronize()
    h_rel = abs(float(h_got) - float(h_ref)) / abs(float(h_ref))
    e_chol = float((a_got.double() - a_ref).abs().max())
    a_rel = e_chol / float(a_ref.abs().max())
    print(f"entry()'s GPR operand (N={len(xs)}, Np={Np}, noise {float(noise):g}): max abs err {e_opnd:.3e} (tol "
          f"{OPERAND_TOL:g} x variance); chol_solve on it: half_logdet rel err {h_rel:.3e} (tol {HLD_TOL:g}), "
          f"alpha rel err {a_rel:.3e} (tol {ALPHA_TOL:g})")
    if not (e_opnd <= OPERAND_TOL and h_rel <= HLD_TOL and a_rel <= ALPHA_TOL):
        raise AssertionError("the operand or the fused Cholesky disagrees at entry()'s shapes")
    errs = {"gram_lower": e_gram, "gram": e_cross, "cholesky": e_fac, "trsm": e_trsm, "operand": e_opnd,
            "chol_solve": e_chol}
    return errs, L, stock_finite


def logdet_gates(torch, cholesky, K, dev):
    """The half-logdet of both Cholesky modes on the grid's lower-tile
    Gram K plus each of LOGDET_JITTERS times I (Np=2048; cond 1.1e6 at
    1e-4), against the float64 factor of the same float32 input: each
    within twice cuSOLVER's float32 error + LOGDET_TOL, relative (fault l's
    gate: the GPLVM's objective and the BayesianGPLVM's bound read this
    logdet at this size)."""
    for jitter in LOGDET_JITTERS:
        Kj = K.clone()
        Kj.diagonal().add_(jitter)
        ref = float(torch.log(torch.diagonal(cholesky.cholesky_plain(torch.tril(Kj).double()))).sum())
        lib = float(torch.log(torch.diagonal(cholesky.cholesky_plain(torch.tril(Kj))).double()).sum())
        fac = float(torch.log(torch.diagonal(cholesky.cholesky_cuda(Kj.clone())).double()).sum())
        fused = float(cholesky.cholesky_solve_cuda(Kj, torch.zeros(len(Kj), 1, device=dev))[2])
        e_lib = abs(lib - ref) / abs(ref)
        tol = 2 * e_lib + LOGDET_TOL
        errs = {"factor only": abs(fac - ref) / abs(ref), "fused": abs(fused - ref) / abs(ref)}
        print(f"half_logdet of the VGP grid's K + {jitter:g} I (Np={len(Kj)}): f64 {ref:.6f}, "
              + ", ".join(f"{k} rel err {e:.3e}" for k, e in errs.items())
              + f", cuSOLVER f32 {e_lib:.3e} (gate 2 x cuSOLVER + {LOGDET_TOL:g} = {tol:.3e})")
        if not max(errs.values()) <= tol:
            raise AssertionError(f"the Cholesky kernels' half-logdet is off f64 at jitter {jitter:g}: {errs}")
        del Kj


def entry_operands(gft, torch, cholesky, dev):
    """entry()'s GPR at its initial hyperparameters, as its kernels take it:
    the scaled inputs, the variance and noise on the card, the padded
    targets and the padded size."""
    model = gft.entry.flagship_model(device=dev)
    n = model.X.shape[0]
    Np = n + (-n) % cholesky.BLOCK
    with torch.no_grad():
        xs = (model.X / model.kern.lengthscales.value).contiguous()
        Dp = torch.zeros(Np, 1, device=dev)
        Dp[:n] = model.Y
        return xs, model.kern.variance.value, model.likelihood.variance.value, Dp, Np


def oa_logdet_check(gft, torch, cholesky, model):
    """OA's half-logdets: A_p = I + lambda_p lambda_p^T o K(X) of the float32
    model at its trained q_lambda, and at ten times it (lambda grows as
    training goes on, and A's condition number with its square), factored
    by the kernel and by cuSOLVER in float32, against float64. The kernel's
    error is gated at twice cuSOLVER's + FACTOR_HLD_TOL: OA's KL takes log
    det A_p from this factor's diagonal. Returns the largest max abs error
    of the factors."""
    with torch.no_grad(), gft.config.temp_settings(use_kernels=True):
        K, lam, _ = model._A_chol()
    eye = torch.eye(model.num_data, dtype=K.dtype, device=K.device)
    err = 0.0
    for grown in (1.0, 10.0):
        for p in range(lam.shape[0]):
            lp = grown * lam[p]
            A = eye + lp[None, :] * lp[:, None] * K
            L = torch.tril(cholesky.cholesky_cuda(A.clone()))
            L_ref = cholesky.cholesky_plain(torch.tril(A).double())
            L_lib = cholesky.cholesky_plain(torch.tril(A))
            h = [float(torch.log(torch.diagonal(f).double()).sum()) for f in (L, L_lib, L_ref)]
            gate(f"OA A_{p} at {grown:g} x the trained lambda (in [{float(lp.min()):.4f}, {float(lp.max()):.4f}]): "
                 f"factor-only Cholesky half_logdet {h[0]:.6f}, cuSOLVER f32 {h[1]:.6f}, f64 {h[2]:.6f}; rel err",
                 abs(h[0] - h[2]) / abs(h[2]), abs(h[1] - h[2]) / abs(h[2]), FACTOR_HLD_TOL)
            err = max(err, float((L.double() - L_ref).abs().max()))
    return err


def vgp_predictions(gft, torch, model, flag):
    """Phase 4g's requests: predict_f at VGP_NQ new points, predict_y there,
    and for the VGP predict_density of the model's own data (a float64
    model's answers on the plain path)."""
    Xq = (vgp_data() if isinstance(model, gft.models.VGP) else oa_data())[2]
    with gft.config.temp_settings(use_kernels=flag, jitter=VGP_JITTER), torch.no_grad():
        out = {"predict_f": model.predict_f(Xq), "predict_y": model.predict_y(Xq)}
        if isinstance(model, gft.models.VGP):
            out["predict_density"] = (model.predict_density(model.X, model.Y),)
    return out


def vgp_checks(gft, torch, gram, cholesky, trsm, stock_finite, dev):
    """Phase 4g: the full-data variational slice at full width (float32, the
    kernel route). VGP (Poisson, the 64 x 32 grid): one ELBO and gradient
    (its launches), VGP_STEPS Adam steps, then, at the point they reach, the
    ELBO and every gradient (q_mu, q_sqrt, variance, lengthscales) and
    predict_f, predict_y and predict_density against the f64 plain path;
    VGPOpperArchambeau (3-class MultiClass): the same with q_alpha and
    q_lambda, and predict_f and predict_y. Each is gated within twice the
    use_kernels=False f32 route's error + 1e-5 (values) / 1e-3 (gradients) /
    1e-6 (predictions, absolute), the VGP's at the fixed gates alone where
    ``stock_finite`` is False (the stock f32 factor of the grid's K is not
    finite). Then fit_lbfgs: VGP_STEPS L-BFGS steps on
    entry()'s GPR (N=2048), finite, non-increasing losses, the final
    objective within 1e-5 of the f64 plain path. Returns each path's
    launches (counts set to 0 just before it, read just after) and the
    trained float32 models."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: phase 4g checks the models' products in full float32")
    launches, models = {}, {}
    for which in ("VGP", "OA"):
        m32 = vgp_model(gft, torch, which, torch.float32, dev)
        reset_counts(gram, cholesky, trsm)
        k32 = value_and_grads(gft, m32, True, jitter=VGP_JITTER)
        one = read_counts(gram, cholesky, trsm)
        _, losses = gft.training.fit(m32, num_steps=VGP_STEPS, learning_rate=VGP_LR)
        preds = vgp_predictions(gft, torch, m32, True)
        torch.cuda.synchronize()
        launches[which] = read_counts(gram, cholesky, trsm)
        print(f"{which} objective at its initial point (kernel route) {k32[0]:.6f}; its ELBO + gradient launches "
              f"{one}")
        losses = losses.cpu().numpy()
        print(f"{which} fit: {VGP_STEPS} Adam steps, losses {np.array2string(losses, precision=4)}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{which}: {VGP_STEPS} Adam steps did not lower the loss")
        # the gates at the trained point, where every gradient is away from
        # zero (at the VGP's initial q the lengthscale's gradient is 0)
        m64 = vgp_model(gft, torch, which, torch.float64, dev, like=m32)
        stock = stock_finite or which == "OA"
        gate_against_f64(f"{which} objective after {VGP_STEPS} Adam steps",
                         *(value_and_grads(gft, m, flag, jitter=VGP_JITTER)
                           for m, flag in ((m32, True), (m32, False), (m64, False))), stock_factors=stock)
        gate_predictions(which, preds, vgp_predictions(gft, torch, m32, False),
                         vgp_predictions(gft, torch, m64, False), stock_factors=stock)
        print(f"{which} path (ELBO + gradient, {VGP_STEPS} Adam steps, predict_f and predict_y at {VGP_NQ}"
              + (", predict_density" if which == "VGP" else "") + f"): launches {launches[which]}")
        if which == "VGP":
            ok = one["gram_lower"] == 1 and one["cholesky"] == 1 and one["trsm_wide"] > 0 and not one["gram"]
        else:
            ok = one["gram"] == 1 and one["cholesky"] == OA_CLASSES and one["trsm_wide"] > 0
        if not ok or one["chol_solve"] or one["batched_trsm"]:
            raise AssertionError(f"{which}: the ELBO and gradient did not run the expected kernels: {one}")
        models[which] = m32
        del m64

    # fit_lbfgs on entry()'s GPR
    fn, (gpr,) = gft.entry.entry(device=dev)
    reset_counts(gram, cholesky, trsm)
    loss0, grads0 = fn(gpr)
    _, losses = gft.training.fit_lbfgs(gpr, num_steps=VGP_STEPS)
    torch.cuda.synchronize()
    launches["lbfgs"] = read_counts(gram, cholesky, trsm)
    with torch.no_grad():
        final = gpr.objective().item()
    g64 = gft.entry.flagship_model(device=dev, dtype=np.float64)
    gft.interop.load_unconstrained(g64, {n: p.unconstrained.detach().cpu().numpy()
                                         for n, p in gft.params.parameters(gpr)})
    with torch.no_grad():
        want = g64.objective().item()
    losses = losses.cpu().numpy()
    rel = abs(final - want) / abs(want)
    print(f"entry(): loss {loss0.item():.6f}, gradient {({n: round(g.item(), 4) for n, g in grads0.items()})}; "
          f"fit_lbfgs {VGP_STEPS} steps, losses {np.array2string(losses, precision=6)}; final objective {final:.6f}, "
          f"f64 plain path {want:.6f}, rel err {rel:.3e} (gate {OBJECTIVE_TOL:g}); launches {launches['lbfgs']}")
    if not (np.isfinite(losses).all() and (np.diff(losses) <= 0).all() and losses[-1] < losses[0]):
        raise AssertionError("fit_lbfgs: the losses are not finite and non-increasing")
    if not rel <= OBJECTIVE_TOL:
        raise AssertionError(f"fit_lbfgs: the final objective is {rel:.3e} off the f64 plain path")
    if not (launches["lbfgs"]["operand"] > 0 and launches["lbfgs"]["chol_solve"] > 0):
        raise AssertionError(f"entry() and fit_lbfgs did not run the operand and the fused Cholesky: "
                             f"{launches['lbfgs']}")
    return launches, models


def vgp_launch_check(gft, torch, models):
    """Phase 4g's launch check by torch.profiler: the VGP ELBO and gradient
    launch the lower-tile Gram, the factor-only Cholesky and the wide TRSM
    and no library factorization or triangular solve; the Opper-Archambeau
    ELBO and gradient launch the cross Gram and the factor once per latent
    and no library factorization (its two solves are torch.linalg's, as the
    JAX package makes them with jax.scipy). Prints each one's host syncs
    (count_syncs). Returns the counts per kernel."""
    counts = {}
    for which, need in (("VGP", ("gram_lower_kernel", "chol_diag_kernel", "trsm_group_kernel")),
                        ("OA", ("gram_cross_kernel", "chol_diag_kernel", "trsm_group_kernel"))):
        m = models[which]

        def step():
            m.zero_grad(set_to_none=True)
            with gft.config.temp_settings(jitter=VGP_JITTER):
                m.objective().backward()

        names = device_kernels(torch, step)
        mine = collections.Counter()
        for n, c in names.items():
            if ours(n):
                mine[ours(n)] += c
        libs = library_solves(names)
        factorizations = {n: c for n, c in libs.items() if not any(w in n.lower() for w in ("trsm", "trsv"))}
        counts[which] = dict(mine)
        _, syncs = count_syncs(torch, m.X.device, step)
        print(f"launch check, {which} ELBO + gradient (torch.profiler, kernel route): {dict(mine)}; library "
              f"factorizations and triangular solves: {libs or 'none'}; host syncs {dict(syncs) or 'none'}")
        missing = [k for k in need if not mine.get(k)]
        factors = mine.get("pivot_init_kernel")  # one launch a factorization
        if factors != (1 if which == "VGP" else OA_CLASSES):
            missing.append(f"one factor per latent (pivot_init_kernel {factors})")
        if missing or (libs if which == "VGP" else factorizations):
            raise AssertionError(f"{which}: kernels missing {missing}, library solves {libs}")
    return counts


def vgp_times(gft, torch, gram, cholesky, trsm, L, models, dev, card):
    """Phase 5 for the full-data variational slice: the lower-tile Gram at
    N=2048 (D=2), the factor at Np=2048 (against cholesky_ex), the wide
    TRSM at N=P=2048 (against solve_triangular), the cross Gram at 2048 x
    2048 and 2048 x VGP_NQ (D=2), and entry()'s operand and fused Cholesky
    (N=2048), each against its plain version; then the VGP and Opper-Archambeau ELBO + gradient on both
    routes, with the device's idle share and the peak memory."""
    rows = {}
    X, _, _ = vgp_data()
    xs = (torch.tensor(X, device=dev) / VGP_LS).contiguous()
    var = torch.tensor(1.0, device=dev)
    n = VGP_N
    kernel = lambda: gram.gram_lower_cuda("rbf", xs, var)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, kernel, lambda: gram.gram_lower_plain("rbf", xs, var))
    b_ms, b_by = bound((3 * 2 + 2) * n * (n + 1) // 2, n * n * 4 + n * 2 * 4)
    rows["gram_lower_vgp"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                              **other_ms(torch, kernel)}
    Kp = kernel()
    Kp.diagonal().add_(VGP_JITTER)
    k_ms, p_ms = paired_ms(torch, cholesky.cholesky_cuda, cholesky.cholesky_plain, setup=lambda: (Kp.clone(),))
    lib_ms = statistics.median(cuda_ms(torch, torch.linalg.cholesky_ex, setup=lambda: (Kp.clone(),)))
    b_ms, b_by = bound(n ** 3 / 3, 2 * tri_bytes(n))
    rows["cholesky_vgp"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                            **other_ms(torch, cholesky.cholesky_cuda, torch.linalg.cholesky_ex,
                                       setup=lambda: (Kp.clone(),))}
    B = torch.tensor(np.random.RandomState(13).randn(n, n), dtype=torch.float32, device=dev)
    kernel = lambda: trsm.trsm_cuda(L, B, True)  # noqa: E731
    library = lambda: torch.linalg.solve_triangular(L, B, upper=False)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, kernel, lambda: trsm.solve_triangular_plain(L, B, True))
    lib_ms = statistics.median(cuda_ms(torch, library))
    b_ms, b_by = bound(n * n * n, tri_bytes(n) + 2 * n * n * 4)
    rows["trsm_vgp"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                        **other_ms(torch, kernel, library)}
    # the cross Gram at the slice's two shapes, on OA's points (D=2)
    Xo, _, Xq = oa_data()
    xo = (torch.tensor(Xo, device=dev) / VGP_LS).contiguous()
    for name, x2 in (("gram_vgp_kxx", xo), ("gram_vgp_kxq", (torch.tensor(Xq, device=dev) / VGP_LS).contiguous())):
        m = len(x2)
        kernel = lambda x2=x2: gram.gram_cuda("rbf", xo, x2, var)  # noqa: E731
        k_ms, p_ms = paired_ms(torch, kernel, lambda x2=x2: gram.gram_reference("rbf", xo, x2, var))
        b_ms, b_by = bound((3 * 2 + 2) * n * m, n * m * 4 + (n + m) * 2 * 4)
        rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                      **other_ms(torch, kernel)}
    # entry()'s GPR: the operand and the fused Cholesky at N=2048
    xs_e, var_e, noise_e, Dp, Np = entry_operands(gft, torch, cholesky, dev)
    opnd = lambda: gram.gram_chol_operand_cuda("rbf", xs_e, var_e, noise_e, Np)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, opnd, lambda: gram.gram_chol_operand_plain("rbf", xs_e, var_e, noise_e, Np))
    b_ms, b_by = bound(5 * Np * (Np + 1) // 2, tri_bytes(Np) + len(xs_e) * 4)
    rows["gram_chol_operand_entry"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                                       "bound_by": b_by, **other_ms(torch, opnd)}
    Ke = opnd()
    chol = lambda K: cholesky.cholesky_solve_cuda(K, Dp)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, chol, lambda K: cholesky.cholesky_solve_plain(K, Dp), setup=lambda: (Ke.clone(),))
    b_ms, b_by = bound(Np ** 3 / 3 + 2 * Np ** 2, 2 * tri_bytes(Np) + 2 * Np * 4)
    rows["chol_solve_logdet_entry"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                                       "bound_by": b_by, **other_ms(torch, chol, setup=lambda: (Ke.clone(),))}

    def ms(t):
        return "-" if t is None else f"{t:.4f}"

    for name, r in rows.items():
        print(f"  {name}: kernel {ms(r['ms'])} ms (runs of {RUN} {ms(r['run20_ms'])}, device {ms(r['device_ms'])}; "
              f"host {(r['ms'] - r['device_ms']) * 1e3:.2f} us a call), "
              f"plain f32 {ms(r['plain_ms'])} ms, library {ms(r['library_ms'])} ms (runs of {RUN} "
              f"{ms(r['library_run20_ms'])}, device {ms(r['library_device_ms'])}), bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")

    print(f"times of the full-data variational slice (N={VGP_N}; median of {2 * REPS} by CUDA events) on {card}:")
    for which, m in models.items():
        def step(flag):
            def run():
                with gft.config.temp_settings(use_kernels=flag, jitter=VGP_JITTER):
                    m.zero_grad(set_to_none=True)
                    m.objective().backward()
            return run

        k_ms, p_ms = paired_ms(torch, step(True), step(False))
        parts = []
        for flag, wall in ((True, k_ms), (False, p_ms)):
            busy = device_busy_ms(torch, step(flag))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(flag)()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            parts.append(f"{'kernels' if flag else 'use_kernels=False'} {wall:.3f} ms (device busy {busy:.3f} ms, "
                         f"idle share {1 - busy / wall:.4f}; peak memory above the model {peak:.3f} GB)")
        print(f"  {which} ELBO + gradient: " + ", ".join(parts))
    return rows


# -- phase 4h: the matrix-free and latent-variable slice ---------------------

def deep_data():
    """Example 05's data (examples/05_deep_kernel.py) at N=CG_N: X uniform
    on [-1, 1]^2, Y = sin(3 (x1 + 0.5 x2)) + 0.05 noise, RandomState(0)."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-1, 1, (CG_N, 2))
    Y = np.sin(3 * (X[:, :1] + 0.5 * X[:, 1:2])) + 0.05 * rng.randn(CG_N, 1)
    return X.astype(np.float32), Y.astype(np.float32)


def deep_model(gft, torch, dtype, dev, like=None):
    """BASELINE config #5 on one chip: GPRCG(materialize_k=False) on
    DeepKernel(2, RBF(1, lengthscales=0.5), mlp_warp([2, 16, 1])), the JAX
    package's defaults otherwise (16 probes, 100 CG iterations, 25 Lanczos
    steps, the likelihood's default noise); the warp drawn from a seeded
    generator. ``like``: a model whose state it takes."""
    X, Y = deep_data()
    warp = gft.kernels_deep.mlp_warp([2, 16, 1], torch.Generator().manual_seed(0))
    kern = gft.kernels_deep.DeepKernel(2, gft.kernels.RBF(1, lengthscales=0.5), warp)
    m = gft.models.GPRCG(X, Y, kern=kern, materialize_k=False, device=dev, dtype=dtype)
    if like is not None:
        m.load_state_dict(like.state_dict())
    return m


class FixedProbes:
    """Puts given probe matrices in place of ``ops.iterative.cg_probes``
    (the one function GPRCG draws its probes from), cast to the dtype asked
    for: every route then sees the same probes."""

    def __init__(self, gft, torch, n, num, dev):
        it = gft.ops.iterative
        seed = torch.tensor(20261017, device=dev)
        self.it, self.Z = it, (it.rademacher(seed, 0, (n, num), torch.float64),
                               it.rademacher(seed, 1, (n, num), torch.float64))

    def __enter__(self):
        self.orig = self.it.cg_probes
        self.it.cg_probes = lambda params, n, num, dtype: tuple(z.to(dtype) for z in self.Z)
        return self

    def __exit__(self, *exc):
        self.it.cg_probes = self.orig


def profile_once(torch, fn, calls=2):
    """One profile of ``calls`` calls of fn (after one outside it): the
    device kernels by name (the most launches of a name in any one call),
    the device's busy ms a call and the device ms a call of each name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names, per_name, busy = collections.Counter(), collections.Counter(), 0.0
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name]
        names |= collections.Counter(e.name for e in dev if "Memcpy" not in e.name and "Memset" not in e.name)
        for e in dev:
            per_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / calls
        busy += busy_ms(dev) / calls
    return names, busy, per_name


def cg_checks(gft, torch, gram, cholesky, trsm, dev, card):
    """Phase 4h, config #5 on one chip: GPRCG streaming with the deep kernel
    at N=CG_N on fixed probes. One objective + gradient on the kernel route
    (its cross-Gram launches: once a panel a matvec, CG_ITERS + SLQ_STEPS
    matvecs, then the surrogate's panels and their recomputation in the
    backward; its peak memory above the model, under a materialized K's
    10 GB; its final CG residual norms), on the use_kernels=False route and
    on the f64 plain path: the value within twice the stock route's error +
    1e-5 and every gradient 1e-3 (max-norm, relative) of f64, the warp's
    layer by layer (its last bias's, zero in exact arithmetic, checked zero
    on the f64 path). Then the wall
    time of objective + gradient on both routes, the device's idle share
    and device time by kernel, a profile that holds no library
    factorization or triangular solve (``torch.linalg.eigh`` of the Lanczos
    matrices, which the JAX package calls as ``jnp.linalg.eigh``, launches
    none of LIBRARY_SOLVES' names), and the host syncs of an
    evaluation: one, ``torch.linalg.eigh``'s read of its info after the
    Lanczos loop, none from a matvec or a CG iteration. Returns the path's
    launches and times, and the float32 model."""
    cg_gpr = gft.models.cg_gpr
    panels = -(-CG_N // cg_gpr.STREAM_BLOCK)
    m32 = deep_model(gft, torch, torch.float32, dev)
    m64 = deep_model(gft, torch, torch.float64, dev, like=m32)
    out = {}
    with FixedProbes(gft, torch, CG_N, m32.num_probes, dev):
        reset_counts(gram, cholesky, trsm)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k32 = value_and_grads(gft, m32, True, jitter=VGP_JITTER)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = read_counts(gram, cholesky, trsm)
        res_k = m32.last_cg_residuals.cpu().numpy()
        p32 = value_and_grads(gft, m32, False, jitter=VGP_JITTER)
        res_p = m32.last_cg_residuals.cpu().numpy()
        r64 = value_and_grads(gft, m64, False, jitter=VGP_JITTER)
        res_64 = m64.last_cg_residuals.cpu().numpy()
        matvecs = m32.cg_iters + m32.slq_steps
        want = panels * (matvecs + 2)
        shape = (cg_gpr.STREAM_BLOCK, CG_N)
        print(f"config #5 (GPRCG streaming, DeepKernel, N={CG_N}, {panels} panels of {cg_gpr.STREAM_BLOCK}): "
              f"objective + gradient launches {launches}; cross Gram at {shape}: "
              f"{launches['gram_by_shape'].get(shape, 0)} (want {panels} x ({matvecs} matvecs + the surrogate's "
              f"forward and backward) = {want}); peak memory above the model {peak:.3f} GB (a materialized f32 K: "
              f"{CG_N ** 2 * 4 / 1e9:.1f} GB)")
        for route, res in (("kernel route", res_k), ("use_kernels=False", res_p), ("f64 plain path", res_64)):
            print(f"  final CG residual norms, {route}: y {res[0]:.3e}, probes max {res[1:].max():.3e}")
        if launches["gram_by_shape"] != {shape: want} or launches["gram"] != want:
            raise AssertionError(f"config #5: the cross Gram did not launch once a panel a matvec: {launches}")
        if any(launches[k] for k in ("operand", "gram_lower", "cholesky", "chol_solve", "trsm_thin", "trsm_wide",
                                     "batched_trsm")):
            raise AssertionError(f"config #5 launched a factorization or solve kernel: {launches}")
        if not peak < CG_N ** 2 * 4 / 1e9:
            raise AssertionError(f"config #5's peak memory {peak:.3f} GB is not below a materialized K's")
        # the warp's last bias shifts every warped input alike: the RBF does not see it
        gate_against_f64(f"config #5 GPRCG objective (N={CG_N}, fixed probes)", k32, p32, r64,
                         zero=(f"kern.warp.layers.{len(m32.kern.warp.layers) - 1}.bias",))

        def step(flag):
            def run():
                with gft.config.temp_settings(use_kernels=flag):
                    m32.zero_grad(set_to_none=True)
                    m32.objective().backward()
            return run

        k_ms, p_ms = (statistics.median(cuda_ms(torch, step(f), reps=2, warmup=1)) for f in (True, False))
        names, busy, per_name = profile_once(torch, step(True))
        _, syncs = count_syncs(torch, dev, step(True))
    libs = library_solves(names)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"config #5 objective + gradient on {card}: kernel route {k_ms:.1f} ms (device busy {busy:.1f} ms, idle "
          f"share {1 - busy / k_ms:.4f}), use_kernels=False {p_ms:.1f} ms; device ms by kernel: "
          + ", ".join(f"{n[:48]} {t:.1f}" for n, t in top))
    print(f"  launches a call (profiler): {sum(names.values())}; library factorizations and triangular solves "
          f"{libs or 'none'}; host syncs {dict(syncs) or 'none'}")
    if libs:
        raise AssertionError(f"config #5 ran a library factorization or solve: {libs}")
    # torch.linalg.eigh reads its info back (one sync an evaluation, after
    # the Lanczos loop); any other sync fails
    src = os.path.join("gpflow_slim_tpu_torch", "ops", "iterative.py")
    with open(os.path.join(HERE, src)) as f:
        eigh_line = next(f"{src}:{i}" for i, line in enumerate(f, 1) if "torch.linalg.eigh(" in line)
    other = {k: c for k, c in syncs.items() if k != eigh_line}
    if other or syncs.get(eigh_line, 0) > 1:
        raise AssertionError(f"config #5 synced the host beyond eigh's one read: {dict(syncs)}")
    out["config5"] = {"launches": launches, "obj_grad_ms": k_ms, "plain_ms": p_ms, "busy_ms": busy, "peak_gb": peak}
    del m64
    return out, m32


def exact_vs_cg(gft, torch, dev):
    """Phase 4h: GPRCG on bench.py's GPR (N=10000, RBF lengthscale 0.1,
    noise 1), float32 on the kernel route. materialize_k with a rank-
    CG_PRECOND pivoted-Cholesky preconditioner: its estimate within CG_REL
    (the SLQ Monte-Carlo tolerance of tests/test_iterative.py) of the exact
    GPR's f64 oracle; the preconditioned CG's residuals after CG_CMP_ITERS
    iterations no larger than the plain CG's; predict_f at NQ points within
    twice the use_kernels=False route's error + CG_PRED_ABS of the exact
    GPR's f64 predictions. Streaming and materialized (no preconditioner)
    on the same probes: the value within 1e-5 and every gradient 1e-3
    (max-norm) of each other."""
    X, Y = bench_data()
    it = gft.ops.iterative

    def model(**kw):
        return gft.models.GPRCG(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE), device=dev,
                                dtype=torch.float32, **kw)

    pre = model(precond_rank=CG_PRECOND)
    with torch.no_grad():
        est = -pre.objective().item()
    hyp = (pre.kern.lengthscales.value.item(), pre.kern.variance.value.item(), pre.likelihood.variance.value.item())
    oracle = -oracle_objective(torch, X, Y, *hyp)
    rel = abs(est - oracle) / abs(oracle)
    print(f"GPRCG (N={N}, materialize_k, precond_rank {CG_PRECOND}) log marginal likelihood {est:.4f}, exact GPR "
          f"f64 oracle {oracle:.4f}: rel err {rel:.3e} (gate {CG_REL:g})")
    if not rel <= CG_REL:
        raise AssertionError(f"GPRCG's estimate is {rel:.3e} off the exact GPR")
    with torch.no_grad():
        K = pre.kern.K(pre.X)
        noise = torch.squeeze(pre.likelihood.variance.value)
        B = torch.cat([pre.Y, it.rademacher(torch.tensor(5, device=dev), 0, (N, 16), torch.float32)], 1)
        mv = lambda v: K @ v + noise * v  # noqa: E731
        wood = it.woodbury_solve_fn(it.pivoted_cholesky(K, CG_PRECOND), noise)
        _, r_pre = it.batched_cg(mv, B, max_iters=CG_CMP_ITERS, precond=wood)
        _, r_plain = it.batched_cg(mv, B, max_iters=CG_CMP_ITERS)
        del K
    print(f"  CG residual norms after {CG_CMP_ITERS} iterations (y and 16 probes): preconditioned max "
          f"{float(r_pre.max()):.3e}, plain max {float(r_plain.max()):.3e}")
    if not bool((r_pre <= r_plain).all()):
        raise AssertionError("the preconditioned CG's residuals are larger than the plain CG's")
    rq = np.random.RandomState(8)
    Xq = rq.uniform(0, 1, (NQ, 1)).astype(np.float32)
    m_o, v_o = oracle_predict(torch, X, Y, Xq, *hyp)
    preds = {}
    for flag in (True, False):
        with gft.config.temp_settings(use_kernels=flag), torch.no_grad():
            preds[flag] = pre.predict_f(Xq)
    for i, what in enumerate(("mean", "var")):
        o = (m_o, v_o)[i].reshape(preds[True][i].shape)
        gate(f"GPRCG predict_f {what} at {NQ} vs the exact GPR's f64 predictions (max abs)",
             float((preds[True][i].double() - o).abs().max()), float((preds[False][i].double() - o).abs().max()),
             CG_PRED_ABS)
    with FixedProbes(gft, torch, N, 16, dev):
        a = value_and_grads(gft, model(materialize_k=True), True, jitter=VGP_JITTER)
        b = value_and_grads(gft, model(materialize_k=False), True, jitter=VGP_JITTER)
    d_val = abs(a[0] - b[0]) / abs(a[0])
    d_grad = max(float((a[1][n] - b[1][n]).abs().max()) / float(a[1][n].abs().max()) for n in a[1])
    print(f"GPRCG streaming vs materialized (N={N}, the same probes): value rel diff {d_val:.3e} (gate "
          f"{OBJECTIVE_TOL:g}), gradients max-norm rel diff {d_grad:.3e} (gate {GRAD_TOL:g})")
    if not (d_val <= OBJECTIVE_TOL and d_grad <= GRAD_TOL):
        raise AssertionError("GPRCG streaming and materialized disagree on the same probes")


def slice_times(gft, torch, gram, trsm, cg_model, lvm_model_, dev):
    """Phase 3 and phase 5 for phase 4h's slice, at the shapes its path
    runs: the cross Gram at config #5's streaming panel (4096 x CG_N of the
    warped inputs, D=1) and the wide TRSM at the BayesianGPLVM's L^-1 psi1^T
    (N=LVM_M, P=LVM_N), each held to its plain version in f64 at phase 3's
    gates (OPERAND_TOL x variance absolute; TRSM_TOL relative, max-norm),
    then timed against its plain f32 version (and the TRSM against
    solve_triangular). Each row carries its max abs error."""
    rows = {}
    block = gft.models.cg_gpr.STREAM_BLOCK
    with torch.no_grad():
        H = (cg_model.kern.warp(cg_model.X) / cg_model.kern.base_kernel.lengthscales.value).contiguous()
        var = cg_model.kern.base_kernel.variance.value.detach().reshape(())
    xb = H[:block].contiguous()
    kernel = lambda: gram.gram_cuda("rbf", xb, H, var)  # noqa: E731
    want = gram.gram_reference("rbf", xb.double(), H.double(), var.double())
    err = float((kernel().double() - want).abs().max())
    del want
    print(f"gram (cross) rbf D=1 at config #5's panel ({block} x {CG_N}): max abs err {err:.3e} vs f64 (tol "
          f"{OPERAND_TOL:g} x variance {float(var):.4f})")
    if not err <= OPERAND_TOL * float(var):
        raise AssertionError(f"cross-Gram kernel disagrees at config #5's panel: {err}")
    k_ms, p_ms = paired_ms(torch, kernel, lambda: gram.gram_reference("rbf", xb, H, var))
    b_ms, b_by = bound(5 * block * CG_N, block * CG_N * 4 + (block + CG_N) * 4)
    rows["gram_cg_panel"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                             "max_abs_err": err, **other_ms(torch, kernel)}
    m = lvm_model_
    with gft.config.temp_settings(jitter=VGP_JITTER), torch.no_grad():
        Z = m.feature.Z.value
        L = gft.ops.linalg.cholesky(gft.features.Kuu(m.feature, m.kern, jitter=VGP_JITTER))
        _, psi1, _ = gft.conditionals.psi_statistics(m.kern, Z, m.X_mean.value, m.X_var.value)
    B = psi1.T.contiguous()
    kernel = lambda: trsm.trsm_cuda(L, B, True)  # noqa: E731
    want = trsm.solve_triangular_plain(L.double(), B.double(), True)
    err = float((kernel().double() - want).abs().max())
    rel = err / float(want.abs().max())
    print(f"trsm lower at the BayesianGPLVM's L^-1 psi1^T (N={LVM_M}, P={LVM_N}): rel err {rel:.3e} vs f64 "
          f"(tol {TRSM_TOL:g})")
    if not rel <= TRSM_TOL:
        raise AssertionError(f"TRSM kernel disagrees at the BayesianGPLVM's shape: {rel}")
    library = lambda: torch.linalg.solve_triangular(L, B, upper=False)  # noqa: E731
    k_ms, p_ms = paired_ms(torch, kernel, lambda: trsm.solve_triangular_plain(L, B, True))
    b_ms, b_by = bound(LVM_M * LVM_M * LVM_N, LVM_M * (LVM_M + 1) // 2 * 4 + 2 * LVM_M * LVM_N * 4)
    rows["trsm_bgplvm"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": statistics.median(cuda_ms(torch, library)),
                           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
                           **other_ms(torch, kernel, library)}
    for name, r in rows.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms (runs of {RUN} {r['run20_ms']:.4f}, device {r['device_ms']:.4f}), "
              f"plain f32 {r['plain_ms']:.4f} ms, library "
              + ("-" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms") + f", bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})")
    return rows


def lvm_data():
    """Example 08's data (examples/08_gplvm_latent_discovery.py) at
    N=LVM_N: 2-D latents, P=12 outputs tanh(X W) + 0.05 noise,
    RandomState(0); and LVM_NQ new latent points."""
    rng = np.random.RandomState(0)
    X_true = rng.randn(LVM_N, LVM_Q)
    W = rng.randn(LVM_Q, LVM_P)
    Y = np.tanh(X_true @ W) + 0.05 * rng.randn(LVM_N, LVM_P)
    Xq = rng.randn(LVM_NQ, LVM_Q)
    return Y.astype(np.float32), Xq.astype(np.float32)


def lvm_model(gft, torch, which, dtype, dev, like=None):
    """Phase 4h's GPLVM (PCA initialization, RBF ARD) or BayesianGPLVM (q(X)
    from the PCA latents with variance 0.1, M=LVM_M inducing points, RBF
    ARD); ``like``: a model whose state it takes."""
    Y, _ = lvm_data()
    X0 = gft.models.pca_reduce(Y, LVM_Q)
    kern = gft.kernels.RBF(LVM_Q, ARD=True)
    if which == "GPLVM":
        m = gft.models.GPLVM(Y, LVM_Q, X_mean=X0, kern=kern, device=dev, dtype=dtype)
    else:
        m = gft.models.BayesianGPLVM(X0, np.full_like(X0, 0.1), Y, kern, M=LVM_M, device=dev, dtype=dtype)
    if like is not None:
        m.load_state_dict(like.state_dict())
    return m


def print_unrefined(gft, m32, ref64):
    """The BayesianGPLVM's float32 errors against the f64 plain path with
    its solves against Kuu's factor unrefined (``ops.linalg``'s
    ``solve_lower_refined`` as ``solve_lower``), on both routes: printed
    beside the gate, which holds the model as it runs (refined on either
    route), not gated."""
    la = gft.ops.linalg
    refined = la.solve_lower_refined
    la.solve_lower_refined = la.solve_lower
    try:
        runs = [value_and_grads(gft, m32, flag, jitter=VGP_JITTER) for flag in (True, False)]
    finally:
        la.solve_lower_refined = refined
    v64, g64 = ref64
    errs = [f"value {abs(runs[0][0] - v64) / abs(v64):.3e} / {abs(runs[1][0] - v64) / abs(v64):.3e}"]
    for n, want in g64.items():
        scale = float(want.abs().max())
        errs.append(f"{n} " + " / ".join(f"{float((g[n] - want).abs().max()) / scale:.3e}" for _, g in runs))
    print("  unrefined Kuu solves (kernel route / use_kernels=False; rel err vs the f64 plain path, gradients "
          "max-norm; not gated): " + "; ".join(errs))


def lvm_checks(gft, torch, gram, cholesky, trsm, dev):
    """Phase 4h: GPLVM and BayesianGPLVM at N=LVM_N (float32, the kernel
    route). Each: one objective + gradient (its launches), LVM_STEPS Adam
    steps, then the objective and every gradient (X, or X_mean, X_var and
    Z, and the hyperparameters) and predict_f at LVM_NQ points against the
    f64 plain path within twice the use_kernels=False route's error + 1e-5
    / 1e-3 / 1e-6 (the BayesianGPLVM's errors with its Kuu solves unrefined
    printed beside, not gated); a profile of the objective + gradient: the lower-tile
    Gram (GPLVM) or the cross Gram (BayesianGPLVM), the factor-only
    Cholesky and the TRSM launch, and no library factorization (GPLVM:
    ``densities.multivariate_normal``'s solve is torch.linalg's, as the JAX
    package's is jax.scipy's). Then ``uncertain_conditional`` on the trained
    BayesianGPLVM's optimal q(u) (whitened), RBF (closed form) and Matern32
    (quadrature), against the f64 plain path. Returns the launches and the
    trained models."""
    launches, models = {}, {}
    _, Xq = lvm_data()
    for which, lr, need in (("GPLVM", LVM_LR, ("gram_lower_kernel", "chol_diag_kernel", "trsm_group_kernel")),
                            ("BayesianGPLVM", LVM_LR / 2, ("gram_cross_kernel", "chol_diag_kernel"))):
        m32 = lvm_model(gft, torch, which, torch.float32, dev)
        reset_counts(gram, cholesky, trsm)
        k0 = value_and_grads(gft, m32, True, jitter=VGP_JITTER)
        one = read_counts(gram, cholesky, trsm)
        ran = (one["gram_lower"] if which == "GPLVM" else one["gram"]) and one["cholesky"] >= (
            1 if which == "GPLVM" else 2) and one["trsm_wide"] + one["trsm_thin"] > 0
        if not ran or one["chol_solve"] or one["operand"]:
            raise AssertionError(f"{which}: the objective and gradient did not run the expected kernels: {one}")
        with gft.config.temp_settings(jitter=VGP_JITTER):
            _, losses = gft.training.fit(m32, num_steps=LVM_STEPS, learning_rate=lr)
            with torch.no_grad():
                pred = m32.predict_f(Xq)
        torch.cuda.synchronize()
        launches[which] = read_counts(gram, cholesky, trsm)
        losses = losses.cpu().numpy()
        print(f"{which} (N={LVM_N}, P={LVM_P}, Q={LVM_Q}" + (f", M={LVM_M}" if which != "GPLVM" else "")
              + f"): objective {k0[0]:.6f}, its objective + gradient launches {one}; {LVM_STEPS} Adam steps "
              f"(lr {lr:g}), losses {np.array2string(losses, precision=4)}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{which}: {LVM_STEPS} Adam steps did not lower the loss")
        m64 = lvm_model(gft, torch, which, torch.float64, dev, like=m32)
        runs = [value_and_grads(gft, m, flag, jitter=VGP_JITTER) for m, flag in ((m32, True), (m32, False),
                                                                                  (m64, False))]
        gate_against_f64(f"{which} objective after {LVM_STEPS} Adam steps", *runs)
        if which == "BayesianGPLVM":
            print_unrefined(gft, m32, runs[2])
        with gft.config.temp_settings(use_kernels=False, jitter=VGP_JITTER), torch.no_grad():
            plain, ref = m32.predict_f(Xq), m64.predict_f(Xq)
        gate_predictions(which, {"predict_f": pred}, {"predict_f": plain}, {"predict_f": ref})

        def step():
            with gft.config.temp_settings(jitter=VGP_JITTER):
                m32.zero_grad(set_to_none=True)
                m32.objective().backward()

        names = device_kernels(torch, step)
        mine = collections.Counter()
        for n, c in names.items():
            if ours(n):
                mine[ours(n)] += c
        libs = library_solves(names)
        factorizations = {n: c for n, c in libs.items() if not any(w in n.lower() for w in ("trsm", "trsv"))}
        print(f"launch check, {which} objective + gradient (torch.profiler, kernel route): {dict(mine)}; library "
              f"factorizations and triangular solves: {libs or 'none'}")
        missing = [k for k in need if not mine.get(k)]
        if not (mine.get("trsm_group_kernel") or mine.get("trsm_thin_kernel")):
            missing.append("a TRSM")
        if missing or (factorizations if which == "GPLVM" else libs):
            raise AssertionError(f"{which}: kernels missing {missing}, library solves {libs}")
        models[which] = (m32, m64)
    # uncertain_conditional on the trained BayesianGPLVM's optimal q(u):
    # whitened, q(v) = N(LB^-T c, B^-1)
    m32, m64 = models["BayesianGPLVM"]
    with gft.config.temp_settings(use_kernels=False, jitter=VGP_JITTER), torch.no_grad():
        _, _, _, LB, c, _, _ = m64._common_factors()
        q_mu = torch.linalg.solve_triangular(LB.T, c, upper=True)
        q_sqrt = torch.linalg.cholesky(torch.cholesky_inverse(LB)).expand(LVM_P, -1, -1)
    Xvar = np.full_like(Xq, 0.05)
    for kname in ("RBF", "Matern32"):
        answers = {}
        for label, m, flag in (("kernel", m32, True), ("stock", m32, False), ("f64", m64, False)):
            dt = m.Y.dtype
            kern = m.kern if kname == "RBF" else gft.kernels.Matern32(
                LVM_Q, variance=m.kern.variance.value.item(), lengthscales=m.kern.lengthscales.value.detach().cpu().numpy(),
                ARD=True).to(device=dev, dtype=dt)
            with gft.config.temp_settings(use_kernels=flag, jitter=VGP_JITTER), torch.no_grad():
                answers[label] = gft.conditionals.uncertain_conditional(
                    torch.tensor(Xq, device=dev, dtype=dt), torch.tensor(Xvar, device=dev, dtype=dt), m.feature, kern,
                    q_mu.to(dt), q_sqrt.to(dt), white=True)
        gate_predictions(f"uncertain_conditional ({kname}, {'closed form' if kname == 'RBF' else 'quadrature'}) on "
                         f"the trained BayesianGPLVM's q(u)", {"moments": answers["kernel"]},
                         {"moments": answers["stock"]}, {"moments": answers["f64"]})
    return launches, {k: v[0] for k, v in models.items()}


def nkn_kernel(gft):
    """Example 06's network (examples/06_nkn_pattern_discovery.py)."""
    k = gft.kernels
    prims = [k.RBF(1, lengthscales=0.5), k.Periodic(1, period=0.7), k.Linear(1), k.Matern32(1, lengthscales=1.0)]
    nkn = gft.kernels_nkn
    return nkn.NKN(1, prims, [nkn.NKNLinear(4, 4), nkn.NKNProduct(4, 2), nkn.NKNLinear(2, 1)])


def nkn_checks(gft, torch, gram, cholesky, trsm, dev):
    """Phase 4h: a GPR on example 06's NKN at bench.py's N=10000 (float32,
    the kernel route): the objective and every gradient against the f64
    plain path within twice the use_kernels=False route's error + 1e-5 /
    1e-3, and a profile of the objective: the stationary primitives (RBF,
    Matern32) run the cross Gram, the objective the padded fused Cholesky,
    and no library factorization or solve. Returns the launches."""
    X, Y = bench_data()
    m32 = gft.models.GPR(X, Y, kern=nkn_kernel(gft), device=dev, dtype=torch.float32)
    m64 = gft.models.GPR(X, Y, kern=nkn_kernel(gft), device=dev, dtype=torch.float64)
    m64.load_state_dict(m32.state_dict())
    reset_counts(gram, cholesky, trsm)
    k32 = value_and_grads(gft, m32, True, jitter=VGP_JITTER)
    launches = read_counts(gram, cholesky, trsm)
    gate_against_f64(f"NKN GPR objective (N={N})", k32, value_and_grads(gft, m32, False, jitter=VGP_JITTER),
                     value_and_grads(gft, m64, False, jitter=VGP_JITTER))
    del m64

    def objective():
        with torch.no_grad():
            m32.objective()

    names = device_kernels(torch, objective)
    mine = collections.Counter()
    for n, c in names.items():
        if ours(n):
            mine[ours(n)] += c
    libs = library_solves(names)
    print(f"NKN GPR objective + gradient launches {launches}; launch check, its objective (torch.profiler, kernel "
          f"route): {dict(mine)}; library factorizations and triangular solves: {libs or 'none'}")
    missing = [k for k in ("gram_cross_kernel", "chol_diag_kernel", "logdet_sum_kernel") if not mine.get(k)]
    if missing or libs or mine.get("gram_cross_kernel") != 2 or launches["chol_solve"] != 1 or launches["gram"] != 2:
        raise AssertionError(f"NKN: kernels missing {missing} or miscounted {dict(mine)}, library solves {libs}")
    return launches


NKN_N = 4000  # the published NKN's gate against its f64 composite (~45 N^2 arrays), beside the phase's models
NKN_ROWS = 1000  # the f64 plain versions' row blocks at N (the VJP's whole block holds ~90 N^2 numbers, 70 GB)
NKN_VJP_TOL = 1e-5  # of each group's largest gradient: float32 entries, summed in float64 past a warp


def nkn_published_kernel(gft):
    """The paper's time-series network (ops.nkn.NET) at port_bench's
    gpr-nkn8-d1 starting values, NKNLinear's default weights."""
    k, nk = gft.kernels, gft.kernels_nkn
    prims = [k.Linear(1, variance=2.0), k.Linear(1, variance=4.0), k.Periodic(1, period=0.25, variance=3.0),
             k.Periodic(1, period=0.1, variance=3.0, lengthscales=0.5), k.RBF(1, variance=3.0, lengthscales=0.05),
             k.RBF(1, variance=3.0, lengthscales=0.3), k.RationalQuadratic(1, variance=3.0, lengthscales=0.1, alpha=0.5),
             k.RationalQuadratic(1, variance=3.0, lengthscales=0.5, alpha=2.0)]
    return nk.NKN(1, prims, [nk.NKNLinear(8, 8), nk.NKNProduct(8, 2), nk.NKNLinear(4, 4), nk.NKNProduct(4, 2),
                             nk.NKNLinear(2, 1)])


def nkn_published_gpr(gft, torch, n, dev, dtype):
    """A GPR on the published NKN over bench.py's first n points, noise 0.1."""
    X, Y = bench_data()
    m = gft.models.GPR(X[:n], Y[:n], kern=nkn_published_kernel(gft), device=dev, dtype=dtype)
    with torch.no_grad():
        p = m.likelihood.variance
        p.unconstrained.copy_(p.transform.backward(torch.tensor(0.1, dtype=torch.float64)))
    return m


def nkn_theta_groups(nkn, D):
    """(name, slice) of ``theta`` (ops.nkn's layout): each primitive's slot,
    then each Linear layer's weights."""
    S = nkn.slot(D)
    groups, at = [(f"primitive {k}", slice(k * S, (k + 1) * S)) for k in range(nkn.PRIMS)], nkn.PRIMS * S
    for j, (_, i, o) in enumerate(layer for layer in nkn.NET if layer[0] == "linear"):
        groups.append((f"W{j + 1}", slice(at, at + i * o)))
        at += i * o
    return groups


def nkn_operand_checks(gft, torch, dev):
    """Phase 4h: a GPR on the published NKN at N = NKN_N, float32 on the
    kernel route: the NKN operand and its VJP launch once each an objective
    + gradient, the value and every gradient within twice the
    use_kernels=False route's error + 1e-5 / 1e-3 of the f64 plain path.
    Then at the main path's size, N = 10000 padded to 10048 (the cell
    nkn-n10k-train's): a float32 objective + gradient launches each kernel
    once (the rows' launches); the forward kernel against its plain version
    in f64 (lower triangle, 2e-6 of the largest entry; the pad exactly the
    identity's) and the VJP against its plain version in f64 on a symmetric
    cotangent, each primitive's slot, each weight matrix and the noise
    within NKN_VJP_TOL of its own largest gradient (both plain versions by
    row blocks of NKN_ROWS). Then phase 5's rows of both, timed against
    their plain versions (the forward in f32, the VJP in f64 by row
    blocks). Returns the rows."""
    from gpflow_slim_tpu_torch.ops import nkn

    def launched(m):
        before = (nkn.nkn_operand_cuda.launches, nkn.nkn_vjp_cuda.launches)
        out = value_and_grads(gft, m, True, jitter=VGP_JITTER)
        launches = (nkn.nkn_operand_cuda.launches - before[0], nkn.nkn_vjp_cuda.launches - before[1])
        if launches != (1, 1):
            raise AssertionError(f"published NKN at N={m.X.shape[0]}: NKN operand and VJP launches {launches}, "
                                 "want one each")
        return out, launches

    m32 = nkn_published_gpr(gft, torch, NKN_N, dev, torch.float32)
    m64 = nkn_published_gpr(gft, torch, NKN_N, dev, torch.float64)
    m64.load_state_dict(m32.state_dict())
    k32, _ = launched(m32)
    gate_against_f64(f"published NKN GPR objective (N={NKN_N})", k32, value_and_grads(gft, m32, False, jitter=VGP_JITTER),
                     value_and_grads(gft, m64, False, jitter=VGP_JITTER))
    del m32, m64, k32
    torch.cuda.empty_cache()

    m = nkn_published_gpr(gft, torch, N, dev, torch.float32)
    _, launches = launched(m)
    Xd = m.X
    pad_to = N + (-N) % 64
    with torch.no_grad():
        theta = m.kern._theta(1, Xd).contiguous()
        noise = m.likelihood.variance.value.reshape(())
    kinds = m.kern._operand_kinds(Xd)
    del m
    fwd = lambda: nkn.nkn_operand_cuda(Xd, theta, noise, kinds, pad_to)  # noqa: E731
    got = fwd()
    X64, th64 = Xd.double(), theta.double()
    fwd_err = scale = 0.0
    for r in range(0, N, NKN_ROWS):
        want = nkn.nkn_gram_plain(X64[r:r + NKN_ROWS], th64, kinds, X64)
        i = torch.arange(want.shape[0], device=dev)
        want[i, i + r] += noise.double()
        low = torch.ones_like(want, dtype=torch.bool).tril_(r)
        fwd_err = max(fwd_err, float((got[r:r + len(i), :N].double() - want)[low].abs().max()))
        scale = max(scale, float(want.abs().max()))
    pad_ok = torch.equal(got[N:, :N], torch.zeros_like(got[N:, :N])) and \
        torch.equal(torch.tril(got[N:, N:]), torch.eye(pad_to - N, device=dev))
    del got, want, low
    G = torch.randn(pad_to, pad_to, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    G = G + G.T
    vjp = lambda: nkn.nkn_vjp_cuda(G, Xd, theta, kinds)  # noqa: E731
    gt, gn = vjp()
    wt, wn = nkn.nkn_vjp_plain(G, Xd, theta, kinds, rows=NKN_ROWS)
    vjp_err = float(torch.cat([gt - wt, (gn - wn)[None]]).abs().max())
    rel = {name: float((gt[sl] - wt[sl]).abs().max()) / float(wt[sl].abs().max())
           for name, sl in nkn_theta_groups(nkn, 1)}
    rel["noise"] = abs(float(gn - wn)) / abs(float(wn))
    print(f"NKN operand vs plain f64 at N={N}, pad_to={pad_to}: max abs err {fwd_err:.3e} (of {scale:.3f}), pad "
          f"exact {pad_ok}; VJP: max abs err {vjp_err:.3e}, of each group's largest gradient: "
          + ", ".join(f"{name} {r:.2e}" for name, r in rel.items()) + f" (tol {NKN_VJP_TOL:g})")
    if not (fwd_err <= 2e-6 * scale and pad_ok and max(rel.values()) <= NKN_VJP_TOL):
        raise AssertionError(f"NKN operand kernels disagree with their plain versions: {fwd_err}, {pad_ok}, {rel}")
    tri = N * (N + 1) // 2
    rows = {}
    for name, kernel, plain, err, (flop, nbytes) in (
            ("nkn_operand", fwd, lambda: nkn.nkn_operand_plain(Xd, theta, noise, kinds, pad_to), fwd_err,
             (170 * tri, tri_bytes(pad_to) + N * 4)),
            ("nkn_vjp", vjp, lambda: nkn.nkn_vjp_plain(G, Xd, theta, kinds, rows=NKN_ROWS), vjp_err,
             (546 * tri, tri_bytes(N) + N * 4))):
        k_ms, p_ms = paired_ms(torch, kernel, plain)
        b_ms, b_by = bound(flop, nbytes)
        rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": err, "launches": launches[name == "nkn_vjp"], **other_ms(torch, kernel)}
    del G
    torch.cuda.empty_cache()
    return rows


# -- phase 4h, fault m on the card; phase 4i: config #3 from disk, resume, serving from a checkpoint ----

def cg_func_check(gft, torch, gram, cholesky, trsm, cg_model, dev):
    """Phase 4h, fault m: ``mcmc.batched_value_and_grad`` (``vmap`` of
    ``grad_and_value``) over FUNC_ROWS rows of config #5's streaming model
    (the float32 model of ``cg_checks``, N=CG_N, deep kernel) on fixed
    probes. Each row's value and gradient against plain autograd's at that
    row, at phase 4h's gates: the row's error against the f64 plain path
    at that row within twice plain autograd's + 1e-5 (value) / 1e-3
    (each leaf's gradient, max-norm; the warp's last bias, zero in exact
    arithmetic, checked zero on the f64 path); the cross Gram exactly once
    a panel a matvec a row (the forward's matvecs, the surrogate's panels
    and their regeneration in the backward); the peak memory above the
    model under a materialized K's. Returns the launches."""
    panels = -(-CG_N // gft.models.cg_gpr.STREAM_BLOCK)
    lp, x0, unpack = gft.mcmc.model_logprob(cg_model)
    lp64 = gft.mcmc.model_logprob(deep_model(gft, torch, torch.float64, dev, like=cg_model))[0]
    z = torch.stack([x0, x0 + 0.01 * torch.tensor(np.random.RandomState(6).randn(x0.shape[0]), dtype=x0.dtype,
                                                     device=dev)])
    sizes = {n: t.numel() for n, t in unpack(x0).items()}

    def by_leaf(g):
        return dict(zip(sizes, torch.split(g.double(), list(sizes.values()))))

    def autograd_at(fn, v):
        v = v.clone().requires_grad_()
        val = fn(v)
        return val.item(), by_leaf(torch.autograd.grad(val, v)[0])

    with FixedProbes(gft, torch, CG_N, cg_model.num_probes, dev):
        reset_counts(gram, cholesky, trsm)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vals, grads = gft.mcmc.base.batched_value_and_grad(lp)(z)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = read_counts(gram, cholesky, trsm)
        want = FUNC_ROWS * panels * (cg_model.cg_iters + cg_model.slq_steps + 2)
        shape = (gft.models.cg_gpr.STREAM_BLOCK, CG_N)
        print(f"config #5 under torch.func (batched_value_and_grad over {FUNC_ROWS} rows, {x0.shape[0]} leaves): "
              f"{seconds:.2f} s; cross Gram at {shape}: {launches['gram_by_shape'].get(shape, 0)} (want {want}); "
              f"peak memory above the model {peak:.3f} GB")
        last_bias = f"kern.warp.layers.{len(cg_model.kern.warp.layers) - 1}.bias"
        for r in range(FUNC_ROWS):
            if not (math.isfinite(float(vals[r])) and bool(grads[r].isfinite().all())):
                raise AssertionError(f"config #5 under torch.func: row {r} is not finite")
            gate_against_f64(f"config #5 under torch.func, row {r} (batched row; plain autograd at the row as the "
                             f"scale)", (float(vals[r]), by_leaf(grads[r])), autograd_at(lp, z[r]),
                             autograd_at(lp64, z[r].double()), zero=(last_bias,))
    if launches["gram_by_shape"] != {shape: want}:
        raise AssertionError(f"config #5 under torch.func: the cross Gram did not launch once a panel a matvec a "
                             f"row: {launches}")
    if not peak < CG_N ** 2 * 4 / 1e9:
        raise AssertionError(f"config #5 under torch.func: peak memory {peak:.3f} GB is not below a materialized K's")
    return launches


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def disk_steps(step, ds, generator, num, dev):
    """``num`` steps of ``step`` on minibatches of SVGP_B rows that ``ds``
    reads from disk (prefetched, in pinned memory, copied to the card
    without blocking); returns the losses."""
    losses = []
    for batch in ds.minibatches(generator, SVGP_B, num, pin_memory=True):
        b = batch.to(dev, non_blocking=True)
        losses.append(step(batch=(b[:, :1], b[:, 1:])))
    return losses


def dp_checks(gft, torch, gram, cholesky, trsm, dev, card, tmp):
    """Phase 4i, config #3 from disk (bench_svgp_natgrad's data and the
    whitened SVGP, float32, on a 1-rank nccl world): svgp_data()'s (X, Y)
    written as a .gfsb file; every prefetched minibatch equal to the gather
    of its indices; DP_STEPS disk-fed steps of make_svgp_step with Adam
    (the cross Gram, factor-only Cholesky and wide TRSM launch every step;
    the loss on a fixed batch finite and lower after); at the trained
    model, dp_value_and_grad on one batch against the single-device value
    and gradient (DP_REL); the step time over DP_PROFILED steady steps, the
    device's idle share (its busy time over DP_PROFILED profiled steps
    against that) and the launches a step. Then check_determinism of one
    step, and a run of DP_RESUME_AT steps checkpointed (model, Adam, the
    index generator, the CUDA generator), loaded into fresh objects and run
    on to DP_STEPS: equal bit for bit to DP_STEPS uninterrupted steps (to
    DP_REL where check_determinism finds a step not deterministic).
    Returns the launches, the trained model and batch, and whether a step
    is deterministic."""
    X, Y, _ = svgp_data()
    path = gft.io.write_gfsb(os.path.join(tmp, "config3.gfsb"), np.hstack([X, Y]))
    ds = gft.io.BinaryDataset(path)
    if not ds.native:
        raise AssertionError("the native loader is not active")
    g, replay = torch.Generator().manual_seed(DP_SEED), torch.Generator().manual_seed(DP_SEED)
    for t, batch in enumerate(ds.minibatches(g, SVGP_B, DP_STEPS, pin_memory=True)):
        idx = torch.randint(0, ds.rows, (SVGP_B,), generator=replay)
        if not (batch.is_pinned() and torch.equal(batch, ds.gather(idx))):
            raise AssertionError(f"prefetched minibatch {t} is not the gather of its indices")
    print(f"config #3 from disk ({path.rsplit(os.sep, 1)[-1]}: {ds.rows} x {ds.cols} float32, native loader): "
          f"{DP_STEPS} prefetched minibatches of {SVGP_B} equal the gathers of their indices")
    first = ds.gather(torch.randint(0, ds.rows, (SVGP_B,), generator=torch.Generator().manual_seed(DP_SEED))).to(dev)
    Xb, Yb = first[:, :1], first[:, 1:]

    gft.parallel.initialize_distributed(f"localhost:{free_port()}", 1, 0)  # nccl on the card
    try:
        mesh = gft.parallel.make_mesh({"data": 1})

        def adam(ps):
            return torch.optim.Adam(ps, lr=SVGP_LR)

        # DP_STEPS disk-fed steps from the model as built
        model = svgp_model(gft, torch, True, torch.float32)
        step, _ = gft.parallel.make_svgp_step(model, adam, mesh=mesh)

        def fixed_loss():
            with torch.no_grad():
                return -(model.build_likelihood_batch(Xb, Yb) + model.log_prior()).item()

        before = fixed_loss()
        reset_counts(gram, cholesky, trsm)
        per_step, losses = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in ds.minibatches(torch.Generator().manual_seed(DP_SEED + 1), SVGP_B, DP_STEPS, pin_memory=True):
            was = read_counts(gram, cholesky, trsm)
            b = batch.to(dev, non_blocking=True)
            losses.append(step(batch=(b[:, :1], b[:, 1:])))
            now = read_counts(gram, cholesky, trsm)
            per_step.append({k: now[k] - was[k] for k in ("gram", "cholesky", "trsm_wide", "trsm_thin")})
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / DP_STEPS
        launches = read_counts(gram, cholesky, trsm)
        after = fixed_loss()
        losses = torch.stack(losses).cpu().numpy()
        print(f"make_svgp_step x {DP_STEPS} from disk (whitened SVGP, M={SVGP_M}, B={SVGP_B}, Adam lr {SVGP_LR}): "
              f"batch losses {losses[0]:.2f} -> {losses[-1]:.2f}; loss on a fixed batch {before:.4f} -> {after:.4f}; "
              f"launches {launches}; a step {per_step[0]}")
        if not (np.isfinite(losses).all() and math.isfinite(after) and after < before):
            raise AssertionError("the data-parallel SVGP did not lower its loss from disk")
        if not all(s["gram"] > 0 and s["cholesky"] > 0 and s["trsm_wide"] + s["trsm_thin"] > 0 for s in per_step):
            raise AssertionError(f"a step did not run the cross Gram, the factor and the TRSM: {per_step}")

        # the trained model (its gradients all live) on the 1-rank world against one device
        loss, grads = gft.parallel.dp_value_and_grad(model, Xb, Yb, mesh)
        model.zero_grad(set_to_none=True)
        single = -(model.build_likelihood_batch(Xb, Yb) + model.log_prior())
        single.backward()
        v_rel = abs(loss.item() - single.item()) / abs(single.item())
        errs = {n: float((grads[n] - t.grad).abs().max()) / float(t.grad.abs().max())
                for n, t in gft.params.trainable_leaves(model) if float(t.grad.abs().max()) > 0}
        print(f"dp_value_and_grad on the 1-rank nccl world vs single-device value_and_grad (B={SVGP_B}): value "
              f"{loss.item():.6f} vs {single.item():.6f}, rel diff {v_rel:.3e}; gradients max-norm rel diff "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + f" (gate {DP_REL:g})")
        if not (v_rel <= DP_REL and all(e <= DP_REL for e in errs.values())):
            raise AssertionError("dp_value_and_grad on the 1-rank world disagrees with the single-device gradient")

        # steady state: DP_PROFILED disk-fed steps by the host's clock, then
        # DP_PROFILED more under torch.profiler for the device's busy time
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        gen = torch.Generator().manual_seed(DP_SEED + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        disk_steps(step, ds, gen, DP_PROFILED, dev)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / DP_PROFILED
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            disk_steps(step, ds, gen, DP_PROFILED, dev)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name]
        busy = busy_ms(events) / DP_PROFILED
        kernels = [e for e in events if "Memcpy" not in e.name and "Memset" not in e.name]
        print(f"config #3 data-parallel step from disk on {card}: {step_ms:.3f} ms a step (wall clock over "
              f"{DP_PROFILED} steady steps, the loader's reads included; the first {DP_STEPS}, the communicator's "
              f"set-up included, {first_ms:.3f} ms a step); device busy {busy:.3f} ms a step (profiler), idle share "
              f"{1 - busy / step_ms:.4f}; {len(kernels) / DP_PROFILED:.1f} device kernels a step (profiler), counters a "
              f"step {per_step[-1]}")
        out = {"launches": launches, "step_ms": step_ms, "idle": 1 - busy / step_ms, "model": model, "batch": (Xb, Yb)}

        # determinism of one step, then checkpoint and resume
        def one_step():
            m = svgp_model(gft, torch, True, torch.float32)
            st, _ = gft.parallel.make_svgp_step(m, adam, mesh=mesh)
            return [st(batch=(Xb, Yb))] + [t.detach().clone() for _, t in gft.params.trainable_leaves(m)]

        deterministic = gft.utils.check_determinism(one_step)
        print(f"utils.check_determinism of one data-parallel step: {deterministic}")
        out["deterministic"] = deterministic

        def state(m, o, gen):
            return {"model": m, "opt": o, "index_gen": gen, "cuda_gen": torch.cuda.default_generators[0]}

        m1 = svgp_model(gft, torch, True, torch.float32)
        s1, _ = gft.parallel.make_svgp_step(m1, adam, mesh=mesh)
        disk_steps(s1, ds, torch.Generator().manual_seed(DP_SEED + 3), DP_STEPS, dev)
        m2 = svgp_model(gft, torch, True, torch.float32)
        s2, o2 = gft.parallel.make_svgp_step(m2, adam, mesh=mesh)
        g2 = torch.Generator().manual_seed(DP_SEED + 3)
        disk_steps(s2, ds, g2, DP_RESUME_AT, dev)
        base = os.path.join(tmp, "dp_ckpt")
        gft.utils.save_checkpoint(base, state(m2, o2, g2), step=DP_RESUME_AT)
        del m2, s2, o2, g2  # the job ends; a new one starts from the checkpoint
        m3 = svgp_model(gft, torch, True, torch.float32)
        s3, o3 = gft.parallel.make_svgp_step(m3, adam, mesh=mesh)
        g3 = torch.Generator().manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gft.utils.load_checkpoint(gft.utils.latest_checkpoint(base), state(m3, o3, g3))
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        disk_steps(s3, ds, g3, DP_STEPS - DP_RESUME_AT, dev)
        pairs = [(n, a.detach(), b.detach()) for (n, a), (_, b) in zip(gft.params.trainable_leaves(m1),
                                                                       gft.params.trainable_leaves(m3))]
        diffs = {n: float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30) for n, a, b in pairs}
        same = all(torch.equal(a, b) for _, a, b in pairs)
        print(f"resume: {DP_RESUME_AT} steps, checkpoint (model, Adam, index and CUDA generators; loaded in "
              f"{load_ms:.1f} ms), {DP_STEPS - DP_RESUME_AT} more from it vs {DP_STEPS} uninterrupted: bit for bit "
              f"{same}; max rel diff " + ", ".join(f"{n} {d:.3e}" for n, d in diffs.items()))
        if not same and (deterministic or not all(d <= DP_REL for d in diffs.values())):
            raise AssertionError("the resumed run does not equal the uninterrupted one")
    finally:
        torch.distributed.destroy_process_group()
        ds.close()
    return out


def serve_ckpt_checks(gft, torch, gram, cholesky, trsm, dev, card, deterministic, tmp):
    """Phase 4i, serving from a checkpoint at bench.py's GPR (N=10000, RBF
    lengthscale 0.1, float32): posterior() -> save_checkpoint ->
    load_checkpoint into a template GPRPosterior of the same shapes from a
    fresh model (its buffers empty: no factorization on the serving side),
    then 4 predict_f requests of NQ points and a full-covariance one of
    NQ_FULL. The answers equal the original posterior's bit for bit (where
    check_determinism found a step not deterministic: within twice the
    original's error against the f64 oracle + SERVE_ABS); the restored side
    launches the cross Gram and the TRSM and no Cholesky. Prints the load
    and per-request times. Returns the launches, the restored posterior and
    a request."""
    X, Y = bench_data()
    model = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE), device=dev, dtype=torch.float32)
    with torch.no_grad():
        post = model.posterior()
    path = gft.utils.save_checkpoint(os.path.join(tmp, "gpr_posterior"), post)
    fresh = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=0.5), device=dev, dtype=torch.float32)
    template = gft.models.posterior.GPRPosterior(fresh.kern, fresh.likelihood, fresh.mean_function, fresh.X,
                                                 torch.empty(post.L.shape, device=dev), torch.empty_like(post.alpha),
                                                 fresh.num_latent)
    rq = np.random.RandomState(2)
    requests = [rq.uniform(0, 1, (NQ, 1)).astype(np.float32) for _ in range(4)]
    Xf = rq.uniform(0, 1, (NQ_FULL, 1)).astype(np.float32)
    reset_counts(gram, cholesky, trsm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = gft.utils.load_checkpoint(path, template)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        got = [restored.predict_f(q) for q in requests] + [restored.predict_f(Xf, full_cov=True)]
        torch.cuda.synchronize()
        launches = read_counts(gram, cholesky, trsm)
        want = [post.predict_f(q) for q in requests] + [post.predict_f(Xf, full_cov=True)]
    same = all(torch.equal(a, b) for g_, w_ in zip(got, want) for a, b in zip(g_, w_))
    print(f"serving from a checkpoint (GPR N={N}, {os.path.getsize(path) / 1e6:.1f} MB): loaded in {load_ms:.1f} ms; "
          f"4 x predict_f at {NQ} and full_cov at {NQ_FULL} equal the original posterior's bit for bit: {same}; "
          f"restored side's launches {launches}")
    if not same:
        if deterministic:
            raise AssertionError("the restored posterior's answers differ from the original's")
        ls, var, noise = (model.kern.lengthscales.value.item(), model.kern.variance.value.item(),
                          model.likelihood.variance.value.item())
        for q, g_, w_ in zip(requests[:1], got, want):
            for what, a, b, o in zip(("mean", "var"), g_, w_, oracle_predict(torch, X, Y, q, ls, var, noise)):
                o = o.reshape(a.shape)
                gate(f"restored predict_f {what} vs f64 oracle (the original's error as the scale)",
                     float((a.double() - o).abs().max()), float((b.double() - o).abs().max()), SERVE_ABS)
    if not (launches["gram"] > 0 and launches["trsm_wide"] > 0 and launches["cholesky"] == 0
            and launches["chol_solve"] == 0):
        raise AssertionError(f"the restored posterior refactorized or skipped a kernel: {launches}")
    q0 = torch.tensor(requests[0], device=dev)

    def request():
        with torch.no_grad():
            restored.predict_f(q0)

    req_ms = statistics.median(cuda_ms(torch, request))
    print(f"  a predict_f request of {NQ} points from the restored cache on {card}: {req_ms:.3f} ms")
    return {"launches": launches, "restored": restored, "q": q0, "load_ms": load_ms, "req_ms": req_ms}


# -- phase 4j: the distributed exact-GP paths on a 1-rank nccl world -----------

def dist_model(gft, torch, dtype, dev, like=None):
    """BASELINE config #5 through the distributed block-Cholesky: GPR on
    example 05's data and deep kernel at N=DIST_N (phase 4h's
    ``deep_data``, the warp drawn from the same seeded generator), the
    likelihood's default noise. ``like``: a model whose state it takes."""
    X, Y = deep_data()
    warp = gft.kernels_deep.mlp_warp([2, 16, 1], torch.Generator().manual_seed(0))
    kern = gft.kernels_deep.DeepKernel(2, gft.kernels.RBF(1, lengthscales=0.5), warp)
    m = gft.models.GPR(X[:DIST_N], Y[:DIST_N], kern=kern, device=dev, dtype=dtype)
    if like is not None:
        m.load_state_dict(like.state_dict())
    return m


def gram_panels(torch, kern, X, out):
    """``out`` (N, N) filled with ``kern.K(X, X)`` by DIST_PANEL-row panels
    (no gradient); returned."""
    with torch.no_grad():
        for r0 in range(0, X.shape[0], DIST_PANEL):
            out[r0:r0 + DIST_PANEL] = kern.K(X[r0:r0 + DIST_PANEL], X)
    return out


def oracle_gpr64(gft, torch, m64):
    """-(log p(Y) + log prior) of a float64 GPR on the card and its gradient
    in every trainable leaf, written out of the port's pieces: K by panels,
    cuSOLVER's f64 factor (``cholesky_ex``), alpha, and the gradient in
    closed form, dmll/dK = W = (beta beta^T - K^-1) / 2 (one output): the
    leaves' gradients are those of sum(W * K) with W held constant, taken
    by autograd through one DIST_PANEL-row panel of K(X, X) at a time, W's
    rows from two f64 triangular solves of identity columns; the noise
    takes tr(W). Peak ~2 N^2 x 8 bytes (K, then its factor). Returns
    ``(value, {name: gradient})``."""
    X, Y = m64.X, m64.Y
    N = X.shape[0]
    with torch.no_grad():
        noise = m64.likelihood.variance.value.detach().reshape(())
        err = Y - m64.mean_function(X)
        K = gram_panels(torch, m64.kern, X, torch.empty((N, N), dtype=torch.float64, device=X.device))
        K.diagonal().add_(noise)
        L, info = torch.linalg.cholesky_ex(K)
        del K
        if int(info) != 0:
            raise AssertionError(f"the f64 oracle's K does not factor (info {int(info)})")
        alpha = torch.linalg.solve_triangular(L, err, upper=False)
        value = (0.5 * N * math.log(2 * math.pi) + float(torch.log(torch.diagonal(L)).sum())
                 + 0.5 * float((alpha ** 2).sum()))
        beta = torch.linalg.solve_triangular(L.T, alpha, upper=True)
    value -= float(m64.log_prior())
    m64.zero_grad(set_to_none=True)
    trW = 0.0
    for r0 in range(0, N, DIST_PANEL):
        r1 = min(r0 + DIST_PANEL, N)
        with torch.no_grad():
            E = torch.zeros((N, r1 - r0), dtype=torch.float64, device=X.device)
            E[r0:r1].fill_diagonal_(1.0)
            Kinv_rows = torch.linalg.solve_triangular(L.T, torch.linalg.solve_triangular(L, E, upper=False),
                                                      upper=True).T
            W = 0.5 * (beta[r0:r1] @ beta.T - Kinv_rows)
            trW += float(W[:, r0:r1].diagonal().sum())
            del E, Kinv_rows
        (-(W * m64.kern.K(X[r0:r1], X)).sum()).backward()
        del W
    del L
    (-(m64.likelihood.variance.value.reshape(()) * trW) - m64.log_prior()).backward()
    return value, {n: t.grad.double() for n, t in gft.params.trainable_leaves(m64)}


def library_f32_value(gft, torch, m32):
    """-(log p(Y) + log prior) of a float32 GPR from cuSOLVER's float32
    factor of the same K (the fallback gate's reference: phase 4g's
    convention for an ill-conditioned K)."""
    X, Y = m32.X, m32.Y
    N = X.shape[0]
    with torch.no_grad():
        K = gram_panels(torch, m32.kern, X, torch.empty((N, N), dtype=torch.float32, device=X.device))
        K.diagonal().add_(m32.likelihood.variance.value.reshape(()))
        L, _ = torch.linalg.cholesky_ex(K)
        del K
        alpha = torch.linalg.solve_triangular(L, Y - m32.mean_function(X), upper=False)
        value = (0.5 * N * math.log(2 * math.pi) + float(torch.log(torch.diagonal(L)).sum())
                 + 0.5 * float((alpha ** 2).sum()) - float(m32.log_prior()))
    return value


def gate_grads(what, got, want, zero=()):
    """Every gradient within GRAD_TOL (relative, max-norm) of ``want``;
    ``zero``: leaves zero in exact arithmetic, checked zero in ``want`` and
    printed, not gated (``gate_against_f64``)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for n, w in want.items():
        if n in zero:
            size = float(w.abs().max())
            print(f"  grad {n}: zero in exact arithmetic, f64 {size:.3e} (largest gradient {top:.3e}); f32 "
                  f"{float(got[n].abs().max()):.3e} (not gated)")
            if not size <= ZERO_GRAD_REL * top:
                raise AssertionError(f"{what}: the gradient of {n} is not zero on the f64 path: {size:.3e}")
            continue
        err = float((got[n].double() - w).abs().max()) / float(w.abs().max())
        worst = max(worst, err)
        print(f"  grad {n} {tuple(w.shape)}: rel err {err:.3e} (gate {GRAD_TOL:g})")
        if not err <= GRAD_TOL:
            raise AssertionError(f"{what}: the gradient of {n} is {err:.3e} off f64")
    return worst


def dist_config5(gft, torch, gram, cholesky, trsm, mesh, dev, card):
    """Phase 4j, BASELINE config #5 through the distributed block-Cholesky
    on one card: ``make_distributed_gpr_loss`` of ``dist_model`` (f32,
    block DIST_BS) at N=DIST_N, one objective + gradient under the
    profiler: its wall time (host clock around the synchronized call), the
    device's busy time and idle share, its peak memory above the model, and
    each kernel's launches (the counters, and the profiler's kernel names:
    no library factorization or triangular solve). The value within
    OBJECTIVE_TOL of the f64 oracle (``oracle_gpr64``), or, where that is
    missed, within twice the f64 error of cuSOLVER's f32 factor of the same
    K + 1e-6 (both printed); every gradient within GRAD_TOL of the f64
    closed form, the warp's last bias checked zero there and not gated."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    m32 = dist_model(gft, torch, torch.float32, dev)
    loss_fn = gft.parallel.make_distributed_gpr_loss(m32, mesh, axis="rows", block_size=DIST_BS)
    named = gft.params.trainable_leaves(m32)
    reset_counts(gram, cholesky, trsm)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = loss_fn(m32)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    launches = read_counts(gram, cholesky, trsm)
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and "Command Buffer Full" not in e.name]
    busy = busy_ms(dev_events)
    names = collections.Counter(e.name for e in dev_events if "Memcpy" not in e.name and "Memset" not in e.name)
    by_time = collections.Counter()
    for e in dev_events:
        by_time[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    del prof, dev_events
    value = loss.item()
    got = {n: g.detach() for (n, _), g in zip(named, grads)}
    del loss, grads
    nb = DIST_N // DIST_BS
    print(f"config #5 distributed (make_distributed_gpr_loss, DeepKernel, N={DIST_N}, block {DIST_BS}, 1-rank nccl) "
          f"objective + gradient on {card}: {wall:.1f} ms (host clock, profiled), device busy {busy:.1f} ms, idle "
          f"share {1 - busy / wall:.4f}; peak memory above the model {peak:.3f} GB (K in f32: "
          f"{DIST_N ** 2 * 4 / 1e9:.1f} GB); launches {launches}")
    top = sorted(by_time.items(), key=lambda kv: -kv[1])[:8]
    print("  device ms by kernel: " + ", ".join(f"{n[:56]} {t:.1f}" for n, t in top))
    libs = library_solves(names)
    seen = {k: sum(c for n, c in names.items() if k in n) for k in ("gram_cross_kernel", "chol_diag_kernel",
                                                                      "trsm_group_kernel", "trsm_thin_kernel")}
    print(f"  device kernels {sum(names.values())}, of them by the profiler {seen}; library factorizations and "
          f"triangular solves {libs or 'none'}")
    if libs:
        raise AssertionError(f"config #5 distributed ran a library factorization or solve: {libs}")
    if not all(seen.values()):
        raise AssertionError(f"the profiler did not see the cross-Gram, factor and TRSM kernels launch: {seen}")
    want = {"cholesky": nb, "gram_by_shape": {(DIST_PANEL, DIST_N): DIST_N // DIST_PANEL}}
    if launches["cholesky"] != nb or launches["trsm_wide"] < nb - 1 or not launches["gram"]:
        raise AssertionError(f"config #5 distributed: the factor, TRSM and cross-Gram kernels did not all launch "
                             f"({launches}; want a factor launch per block, {want})")
    lib32 = library_f32_value(gft, torch, m32)
    m64 = dist_model(gft, torch, torch.float64, dev, like=m32)
    v64, g64 = oracle_gpr64(gft, torch, m64)
    err, lib_err = abs(value - v64) / abs(v64), abs(lib32 - v64) / abs(v64)
    limit = OBJECTIVE_TOL if err <= OBJECTIVE_TOL else 2 * lib_err + 1e-6
    print(f"  value {value:.6f}, f64 oracle {v64:.6f}: rel err {err:.3e}; cuSOLVER f32 factor {lib32:.6f}, rel err "
          f"{lib_err:.3e}; gate {limit:.3e}" + ("" if err <= OBJECTIVE_TOL else " (2 x cuSOLVER f32 + 1e-6)"))
    if not err <= limit:
        raise AssertionError(f"config #5 distributed value is {err:.3e} off f64")
    worst = gate_grads("config #5 distributed", got, g64,
                       zero=(f"kern.warp.layers.{len(m32.kern.warp.layers) - 1}.bias",))
    del m64
    return {"launches": launches, "obj_grad_ms": wall, "busy_ms": busy, "peak_gb": peak, "value_err": err,
            "lib_value_err": lib_err, "grad_err": worst, "model": m32}


def rel_max(got, want):
    return float((got.double() - want).abs().max()) / float(want.abs().max())


def dist_paths(gft, torch, gram, cholesky, trsm, mesh, dev, card):
    """Phase 4j on bench.py's GPR (N=10000, RBF lengthscale 0.1, f32) and on
    1 x 1 meshes: ``make_distributed_gpr_loss`` (block DIST_SMALL_BS) against
    the single-device ``GPR.objective()`` (OBJECTIVE_TOL, GRAD_TOL), the
    value against the f64 oracle (OBJECTIVE_TOL) and every gradient against
    the f64 plain path (GRAD_TOL); ``cyclic_cholesky`` and ``grid_cholesky`` (block
    GRID_BS) against cuSOLVER's f64 factor (FACTOR_TOL, relative max-norm;
    half-logdet FACTOR_HLD_TOL); ``make_grid_gpr_loss`` against the f64
    oracle and the f64 plain path; ``make_distributed_cg_loss`` (the JAX
    package's defaults, fixed probes) within CG_REL of the exact GPR's f64
    oracle; ``ring_gram_matvec`` against K @ v + noise v in f64
    (RING_MATVEC_TOL, relative max-norm). Then config #4's 8 chains through
    ``sample_chains`` on the 1-rank mesh, equal bit for bit to
    ``sample_chains(mesh=None)``, and ``entry.dryrun_multichip(1)``.
    Returns the launches of the distributed loss and the f32 K it factored
    in the cyclic and grid checks."""
    X, Y = bench_data()
    m = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE), device=dev, dtype=torch.float32)
    m64 = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE), device=dev, dtype=torch.float64)
    m64.load_state_dict(m.state_dict())
    named = gft.params.trainable_leaves(m)
    v64_oracle = oracle_objective(torch, X, Y, LENGTHSCALE, 1.0, 1.0)
    _, g64 = value_and_grads(gft, m64, False)

    def vg(loss_fn):
        loss = loss_fn(m)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        return loss.item(), {n: g.detach() for (n, _), g in zip(named, grads)}

    reset_counts(gram, cholesky, trsm)
    v_dist, g_dist = vg(gft.parallel.make_distributed_gpr_loss(m, mesh, axis="rows", block_size=DIST_SMALL_BS))
    launches = read_counts(gram, cholesky, trsm)
    v_one, g_one = vg(lambda mm: mm.objective())
    print(f"distributed GPR on bench.py's GPR (N={N}, block {DIST_SMALL_BS}): {v_dist:.6f}, single-device "
          f"objective {v_one:.6f}, f64 oracle {v64_oracle:.6f}; rel err {abs(v_dist - v64_oracle) / v64_oracle:.3e} "
          f"and {abs(v_one - v64_oracle) / v64_oracle:.3e}; launches {launches}")
    if not abs(v_dist - v64_oracle) / v64_oracle <= OBJECTIVE_TOL:
        raise AssertionError("the distributed GPR's value is off the f64 oracle")
    gate_grads("distributed GPR (N=10000)", g_dist, g64)
    print("  single-device gradients against the same f64: "
          + ", ".join(f"{n} {rel_max(g_one[n], w):.3e}" for n, w in g64.items()))
    # and the two f32 evaluations against each other, at the same gates
    diffs = {n: rel_max(g_dist[n], g_one[n].double()) for n in g_one}
    print(f"  distributed against single-device: value rel {abs(v_dist - v_one) / abs(v_one):.3e}, gradients "
          + ", ".join(f"{n} {d:.3e}" for n, d in diffs.items()))
    if not (abs(v_dist - v_one) / abs(v_one) <= OBJECTIVE_TOL and max(diffs.values()) <= GRAD_TOL):
        raise AssertionError("the distributed GPR differs from the single-device GPR")

    # the cyclic and grid factors of K + noise I, on 1 x 1 meshes
    with torch.no_grad():
        Xs = (m.X / LENGTHSCALE).contiguous()
        K = gram.gram_cuda("rbf", Xs, Xs, torch.ones((), device=dev))
        K.diagonal().add_(1.0)
    L64 = torch.linalg.cholesky(K.double())
    hld64 = float(torch.log(torch.diagonal(L64)).sum())
    mesh2d = gft.parallel.make_mesh({"rows": 1, "cols": 1})
    for what, factor in (("cyclic_cholesky", lambda: gft.parallel.cyclic_cholesky(K, mesh, "rows", GRID_BS)),
                         ("grid_cholesky", lambda: gft.parallel.grid_cholesky(K, mesh2d, ("rows", "cols"), GRID_BS))):
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            L = factor()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        err, hld = rel_max(L, L64), abs(float(torch.log(torch.diagonal(L)).sum()) - hld64) / abs(hld64)
        print(f"{what} (1 x 1 mesh, N={N}, block {GRID_BS}) on {card}: {ms:.1f} ms; factor rel err {err:.3e} "
              f"(gate {FACTOR_TOL:g}), half-logdet rel err {hld:.3e} (gate {FACTOR_HLD_TOL:g}) vs cuSOLVER f64")
        if not (err <= FACTOR_TOL and hld <= FACTOR_HLD_TOL):
            raise AssertionError(f"{what} disagrees with cuSOLVER's f64 factor")
        del L
    del L64

    v_grid, g_grid = vg(gft.parallel.make_grid_gpr_loss(m, mesh2d, ("rows", "cols"), block_size=GRID_BS))
    err = abs(v_grid - v64_oracle) / v64_oracle
    print(f"grid GPR (1 x 1 mesh, block {GRID_BS}): {v_grid:.6f}, rel err {err:.3e} vs the f64 oracle")
    if not err <= OBJECTIVE_TOL:
        raise AssertionError("the grid GPR's value is off the f64 oracle")
    gate_grads("grid GPR (N=10000)", g_grid, g64)

    with FixedProbes(gft, torch, N, 16, dev):
        with torch.no_grad():
            v_cg = gft.parallel.make_distributed_cg_loss(m, mesh, axis="rows")(m).item()
    err = abs(v_cg - v64_oracle) / v64_oracle
    print(f"distributed CG (16 probes, 100 CG iterations, 25 Lanczos steps, fixed probes): {v_cg:.6f}, rel err "
          f"{err:.3e} vs the exact GPR's f64 oracle (gate {CG_REL:g})")
    if not err <= CG_REL:
        raise AssertionError("the distributed CG estimate is off the exact GPR")

    v = torch.randn((N, 3), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    with torch.no_grad():
        out = gft.parallel.ring_gram_matvec(m.kern, m.X, v, mesh, "rows", noise=1.0)
    want = K.double() @ v.double()  # K holds the noise on its diagonal
    err = rel_max(out, want)
    print(f"ring_gram_matvec (N={N}, 3 columns): rel err {err:.3e} vs K @ v in f64 (gate {RING_MATVEC_TOL:g})")
    if not err <= RING_MATVEC_TOL:
        raise AssertionError("ring_gram_matvec disagrees with K @ v")
    del K, want

    cm = config4_model(gft, torch, torch.float32, dev)
    lp, x0, _ = gft.mcmc.model_logprob(cm)
    x0s = x0[None].repeat(NUTS_CHAINS, 1)
    runs = [gft.parallel.sample_chains(lp, x0s, torch.Generator(device=dev).manual_seed(DIST_CHAIN_SEED),
                                       DIST_CHAIN_DRAWS, mesh=mesh_, axis="rows", num_warmup=DIST_CHAIN_DRAWS,
                                       max_depth=NUTS_DEPTH) for mesh_ in (mesh, None)]
    same = torch.equal(runs[0][0], runs[1][0]) and all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[1][1])
    print(f"config #4's {NUTS_CHAINS} chains, {DIST_CHAIN_DRAWS} warmup + {DIST_CHAIN_DRAWS} draws through "
          f"sample_chains on the 1-rank mesh and with mesh=None: bit for bit {same}")
    if not same:
        raise AssertionError("sample_chains on a 1-rank mesh differs from mesh=None")
    out = gft.entry.dryrun_multichip(1)
    print(f"entry.dryrun_multichip(1): every distributed loss equals its unsharded counterpart: {out}")
    return launches


def slice4j_times(gft, torch, gram, cholesky, trsm, m32, dev):
    """Phase 3 and phase 5 for phase 4j, at the shapes config #5's
    distributed path ran its kernels: the cross Gram of a ring panel
    (DIST_PANEL x DIST_N of the warped inputs, D=1), the factor-only
    Cholesky of K's first diagonal block (DIST_BS, padded to the kernel's
    64-multiple) and the wide TRSM of its factor on the panel below it
    (N=DIST_BS, P=DIST_N - DIST_BS), each held to its plain version in f64
    at phase 3's gates, then timed against its plain f32 version and the
    library call where there is one."""
    rows = {}
    bs = DIST_BS
    with torch.no_grad():
        H = (m32.kern.warp(m32.X) / m32.kern.base_kernel.lengthscales.value).contiguous()
        var = m32.kern.base_kernel.variance.value.detach().reshape(())
        noise = m32.likelihood.variance.value.detach().reshape(())
    xb = H[:DIST_PANEL].contiguous()
    rows["gram_dist_panel"] = timed_kernel(
        torch, f"gram_dist_panel (cross Gram, a ring panel, {DIST_PANEL} x {DIST_N})",
        lambda: gram.gram_cuda("rbf", xb, H, var), lambda: gram.gram_reference("rbf", xb, H, var),
        gram.gram_reference("rbf", xb.double(), H.double(), var.double()), abs_err, OPERAND_TOL * float(var),
        5 * DIST_PANEL * DIST_N, DIST_PANEL * DIST_N * 4 + (DIST_PANEL + DIST_N) * 4)
    with torch.no_grad():
        Np = bs + (-bs) % cholesky.BLOCK
        Kp = torch.eye(Np, device=dev)
        Kp[:bs, :bs] = gram.gram_cuda("rbf", H[:bs].contiguous(), H[:bs].contiguous(), var)
        Kp[:bs, :bs].diagonal().add_(noise)
        panel = gram.gram_cuda("rbf", H[:bs].contiguous(), H[bs:].contiguous(), var)  # (bs, N - bs): K[bs:, :bs]^T
    L_ref = cholesky.cholesky_plain(Kp.double())
    lib_rel = rel_err(torch.linalg.cholesky(Kp).double(), L_ref)[1]
    rows["cholesky_dist"] = timed_kernel(
        torch, f"cholesky_dist (factor only, K's first diagonal block, {bs} padded to {Np}; cuSOLVER f32 rel err "
        f"{lib_rel:.3e})", lambda K: cholesky.cholesky_cuda(K).tril_(), cholesky.cholesky_plain, L_ref, rel_err,
        2 * lib_rel + FACTOR_TOL, Np ** 3 / 3, 2 * tri_bytes(Np), library=torch.linalg.cholesky_ex,
        setup=lambda: (Kp.clone(),))
    Lkk = cholesky.cholesky_cuda(Kp.clone()).tril_()[:bs, :bs]
    P = panel.shape[1]
    rows["trsm_dist"] = timed_kernel(
        torch, f"trsm_dist (wide, Lkk^-1 of the panel below it, N={bs}, P={P})",
        lambda: trsm.trsm_cuda(Lkk, panel, True), lambda: trsm.solve_triangular_plain(Lkk, panel, True),
        trsm.solve_triangular_plain(Lkk.double(), panel.double(), True), rel_err, TRSM_TOL, bs * bs * P,
        tri_bytes(bs) + 2 * bs * P * 4, library=lambda: torch.linalg.solve_triangular(Lkk, panel, upper=False))
    return rows


def timed_kernel(torch, name, kernel, plain, want, err_of, gate_tol, flop, nbytes, library=None, setup=None):
    """Hold ``kernel()`` against ``want`` (its plain version in f64) by
    ``err_of`` at ``gate_tol``, then time it against ``plain`` (and
    ``library``): a row of the kernels line with its max abs error."""
    got = kernel() if setup is None else kernel(*setup())
    err, rel = err_of(got.double(), want)
    print(f"{name}: max abs err {err:.3e}, gated {rel:.3e} (tol {gate_tol:.3e})")
    if not rel <= gate_tol:
        raise AssertionError(f"{name} disagrees with its plain version: {rel}")
    k_ms, p_ms = paired_ms(torch, kernel, plain, setup=setup or (lambda: ()))
    lib_ms = statistics.median(cuda_ms(torch, library, setup or (lambda: ()))) if library else None
    b_ms, b_by = bound(flop, nbytes)
    row = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err, **other_ms(torch, kernel, library, setup)}
    print(f"  {name}: kernel {k_ms:.4f} ms (runs of {RUN} {row['run20_ms']}, device {row['device_ms']:.4f}), "
          f"plain f32 {p_ms:.4f} ms, library " + ("-" if lib_ms is None else f"{lib_ms:.4f} ms")
          + f", bound {b_ms:.6f} ms ({b_by})")
    return row


def abs_err(got, want):
    err = float((got - want).abs().max())
    return err, err


def rel_err(got, want):
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def slice4i_times(gft, torch, gram, cholesky, trsm, dp_out, serve_out, dev):
    """Phase 3 and phase 5 for phase 4i, at the shapes its paths ran: the
    cross Gram of the trained data-parallel SVGP's Kuu (256 x 256) and Kuf
    (256 x 1024), the factor-only Cholesky of its Kuu (gated at twice
    cuSOLVER's f32 error + FACTOR_TOL: cond(Kuu) ~1e6) and the wide TRSM
    of its factor on Kuf; the cross Gram (10000 x 2048) and the wide TRSM
    (P = 2048) of a request to the restored posterior; each held to its
    plain version in f64 at phase 3's gates, then timed."""
    rows = {}
    m = dp_out["model"]
    with torch.no_grad():
        ls = m.kern.lengthscales.value.detach()
        var = m.kern.variance.value.detach().reshape(())
        Zs = (m.feature.Z.value / ls).contiguous()
        Xbs = (dp_out["batch"][0] / ls).contiguous()
    for name, xs in (("gram_dp_kuu", Zs), ("gram_dp_kuf", Xbs)):
        n, k = Zs.shape[0], xs.shape[0]
        rows[name] = timed_kernel(
            torch, f"{name} (cross Gram, {n} x {k})", lambda xs=xs: gram.gram_cuda("rbf", Zs, xs, var),
            lambda xs=xs: gram.gram_reference("rbf", Zs, xs, var),
            gram.gram_reference("rbf", Zs.double(), xs.double(), var.double()), abs_err, OPERAND_TOL * float(var),
            5 * n * k, n * k * 4 + (n + k) * 4)
    M = Zs.shape[0]
    with torch.no_grad():
        Kuu = gram.gram_cuda("rbf", Zs, Zs, var) + SVGP_JITTER * torch.eye(M, device=dev)
        Kuf = gram.gram_cuda("rbf", Zs, Xbs, var)
    L_ref = cholesky.cholesky_plain(Kuu.double())
    lib_rel = rel_err(torch.linalg.cholesky(Kuu).double(), L_ref)[1]
    rows["cholesky_dp"] = timed_kernel(
        torch, f"cholesky_dp (factor only, Kuu of the trained model, M={M}; cuSOLVER f32 rel err {lib_rel:.3e})",
        lambda K: cholesky.cholesky_cuda(K).tril_(), cholesky.cholesky_plain, L_ref, rel_err,
        2 * lib_rel + FACTOR_TOL, M ** 3 / 3, 2 * tri_bytes(M), library=torch.linalg.cholesky_ex,
        setup=lambda: (Kuu.clone(),))
    Lm = cholesky.cholesky_cuda(Kuu.clone()).tril_()
    P = Kuf.shape[1]
    rows["trsm_dp"] = timed_kernel(
        torch, f"trsm_dp (wide, Lm^-1 Kuf, N={M}, P={P})", lambda: trsm.trsm_cuda(Lm, Kuf, True),
        lambda: trsm.solve_triangular_plain(Lm, Kuf, True),
        trsm.solve_triangular_plain(Lm.double(), Kuf.double(), True), rel_err, TRSM_TOL, M * M * P,
        tri_bytes(M) + 2 * M * P * 4, library=lambda: torch.linalg.solve_triangular(Lm, Kuf, upper=False))
    post, q = serve_out["restored"], serve_out["q"]
    with torch.no_grad():
        ls = post.kern.lengthscales.value.detach()
        var = post.kern.variance.value.detach().reshape(())
        Xs, Qs = (post.X / ls).contiguous(), (q / ls).contiguous()
        Kx = gram.gram_cuda("rbf", Xs, Qs, var)
    n, k = Xs.shape[0], Qs.shape[0]
    rows["gram_serve_ckpt"] = timed_kernel(
        torch, f"gram_serve_ckpt (cross Gram of a restored request, {n} x {k})",
        lambda: gram.gram_cuda("rbf", Xs, Qs, var), lambda: gram.gram_reference("rbf", Xs, Qs, var),
        gram.gram_reference("rbf", Xs.double(), Qs.double(), var.double()), abs_err, OPERAND_TOL * float(var),
        5 * n * k, n * k * 4 + (n + k) * 4)
    L = post.L
    rows["trsm_serve_ckpt"] = timed_kernel(
        torch, f"trsm_serve_ckpt (wide, the restored L^-1 Kx, N={n}, P={k})", lambda: trsm.trsm_cuda(L, Kx, True),
        lambda: trsm.solve_triangular_plain(L, Kx, True),
        trsm.solve_triangular_plain(L.double(), Kx.double(), True), rel_err, TRSM_TOL, n * n * k,
        tri_bytes(n) + 2 * n * k * 4, library=lambda: torch.linalg.solve_triangular(L, Kx, upper=False))
    return rows


# -- phase 4k: the split-bf16 trailing-update modes ------------------------------

def split_objective(torch, cholesky, model, syrk):
    """GPR.objective() of ``model`` (no priors) with its fused factorization
    in the trailing-update arithmetic ``syrk``: build_likelihood's
    composition (models/gpr.py) on the same public ops, the operand from
    ``kern.gram_chol_operand`` into ``cholesky.cholesky_solve_logdet``."""
    import torch.nn.functional as F

    N = model.X.shape[0]
    d = model.Y - model.mean_function(model.X)
    noise = torch.squeeze(model.likelihood.variance.value)
    Np = N + (-N) % cholesky.BLOCK
    Kp = model.kern.gram_chol_operand(model.X, noise, Np)
    half_logdet, quad = cholesky.cholesky_solve_logdet(Kp, F.pad(d, (0, 0, 0, Np - N)), syrk=syrk)
    P = d.shape[1]
    return 0.5 * N * P * math.log(2.0 * math.pi) + P * half_logdet + 0.5 * quad - model.log_prior()


def split_checks(gft, torch, gram, cholesky, model, grads64, dev):
    """Phase 4k: the split modes through the public entry points, held to
    the JAX package's own hardware gates; returns the main path's launches
    by mode (bench.py's GPR with its factorization in "s3" and "s4") and the
    objective's times."""

    def zero_counts():
        for fn in (cholesky.cholesky_cuda, cholesky.cholesky_solve_cuda):
            fn.by_syrk = dict.fromkeys(fn.by_syrk, 0)

    def read_counts():
        return {"chol_solve": dict(cholesky.cholesky_solve_cuda.by_syrk),
                "cholesky": dict(cholesky.cholesky_cuda.by_syrk)}

    zero_counts()
    # the factor alone (tests/test_tpu_compiled.py:190-211): RBF 0.1 + 1e-2 I at N=2048
    X = np.random.RandomState(0).uniform(0, 1, (SPLIT_FACTOR_N, 1))
    d = torch.tensor(X / 0.1, dtype=torch.float64, device=dev)
    Kd = torch.exp(-0.5 * sq_dist64(torch, d, d)) + SPLIT_FACTOR_JITTER * torch.eye(
        SPLIT_FACTOR_N, dtype=torch.float64, device=dev)
    Ld = torch.linalg.cholesky(Kd)
    K32 = Kd.float()
    for syrk in SPLIT_FACTOR_MODES:
        L = cholesky.cholesky(K32, syrk=syrk).double()
        finite = bool(torch.isfinite(L).all())
        frob = float(torch.linalg.norm(torch.tril(L) - Ld) / torch.linalg.norm(Ld))
        print(f"split factor syrk={syrk} (N={SPLIT_FACTOR_N}, RBF 0.1 + {SPLIT_FACTOR_JITTER:g} I): finite {finite}, "
              f"||tril(L) - L64||_F / ||L64||_F {frob:.3e} (gate {SPLIT_FROB_TOL:g})")
        if not (finite and frob < SPLIT_FROB_TOL):
            raise AssertionError(f"split factor syrk={syrk} misses the JAX package's gate: {frob}")
    factor_launches = read_counts()["cholesky"]
    print(f"split factor launches of the factor-only kernel by arithmetic: {factor_launches}")
    if factor_launches != {**dict.fromkeys(factor_launches, 0),
                           **collections.Counter(cholesky.syrk_base(m) for m in SPLIT_FACTOR_MODES)}:
        raise AssertionError(f"cholesky(K, syrk) did not launch the factor-only kernel in its mode: {factor_launches}")
    del Kd, Ld, K32
    # the fused pipeline in "s4" (tests/test_tpu_compiled.py:214-262): the operand of N=3000 (RBF 0.1,
    # noise 0.01) padded to a multiple of 64, against the f64 factor of the device-computed operand
    rng = np.random.RandomState(0)
    X = rng.uniform(0, 1, (SPLIT_FUSED_N, 1))
    Y = np.sin(12 * X) + 0.1 * rng.randn(SPLIT_FUSED_N, 1)
    n, pad_to = SPLIT_FUSED_N, SPLIT_FUSED_N + (-SPLIT_FUSED_N) % cholesky.BLOCK
    Xs = torch.tensor(X / 0.1, dtype=torch.float32, device=dev)
    Dp = torch.zeros(pad_to, 1, dtype=torch.float32, device=dev)
    Dp[:n] = torch.tensor(Y, dtype=torch.float32, device=dev)
    with torch.no_grad():
        Kp = gram.gram_chol_operand("rbf", Xs, 1.0, SPLIT_FUSED_NOISE, pad_to)
    Kl = Kp[:n, :n].double()
    Ld = torch.linalg.cholesky(torch.tril(Kl) + torch.tril(Kl, -1).T)
    hl_ref = float(torch.log(torch.diagonal(Ld)).sum())
    quad_ref = float((torch.linalg.solve_triangular(Ld, Dp[:n].double(), upper=False) ** 2).sum())
    for syrk in ("hi", "s4"):
        with torch.no_grad():
            hl, quad = cholesky.cholesky_solve_logdet(Kp.clone(), Dp, syrk=syrk)
        e_hl, e_q = abs(float(hl) - hl_ref) / abs(hl_ref), abs(float(quad) - quad_ref) / abs(quad_ref)
        print(f"split fused syrk={syrk} (N={n} -> {pad_to}, RBF 0.1, noise {SPLIT_FUSED_NOISE:g}): half_logdet rel "
              f"err {e_hl:.3e} (gate {SPLIT_HLD_TOL:g}), quad rel err {e_q:.3e} (gate {SPLIT_QUAD_TOL:g})")
        if syrk == "s4" and not (e_hl < SPLIT_HLD_TOL and e_q < SPLIT_QUAD_TOL):
            raise AssertionError(f"the fused s4 pipeline misses the JAX package's gates: {e_hl}, {e_q}")
    del Kp, Kl, Ld
    # the main path at full width: bench.py's GPR (N=10000) with its factorization in "s4", against the
    # f64 oracle and the f64 plain path's gradient; "s3" beside it, not gated
    with torch.no_grad():
        hi_val = float(split_objective(torch, cholesky, model, "hi"))
        val = float(model.objective())
    print(f"split objective syrk=hi {hi_val:.6f} against GPR.objective() {val:.6f} (the same composition)")
    if not abs(hi_val - val) <= 1e-7 * abs(val):
        raise AssertionError("split_objective does not compute GPR.objective()")
    ls_eff = model.kern.lengthscales.value.item()
    oracle = oracle_objective(torch, *bench_data(), ls_eff, model.kern.variance.value.item(),
                              model.likelihood.variance.value.item())
    zero_counts()  # the main path's own run: the counts are read just after it
    for syrk in ("s3", "s4"):
        model.zero_grad(set_to_none=True)
        obj = split_objective(torch, cholesky, model, syrk)
        obj.backward()
        obj = float(obj.detach())
        rel = abs(obj - oracle) / abs(oracle)
        print(f"split objective syrk={syrk} at N={N}: {obj:.6f}, f64 oracle {oracle:.6f}, rel {rel:.3e}"
              + (f" (gate {OBJECTIVE_TOL:g})" if syrk == "s4" else " (not gated)"))
        if syrk == "s4" and not rel <= OBJECTIVE_TOL:
            raise AssertionError(f"the s4 objective is off the f64 oracle by {rel:.3e}")
        for name, p in gft.params.parameters(model):
            g_rel = abs(float(p.unconstrained.grad) - grads64[name]) / abs(grads64[name])
            print(f"  grad {name}: syrk={syrk} {float(p.unconstrained.grad):.6f}, plain f64 {grads64[name]:.6f}, "
                  f"rel err {g_rel:.3e}" + (f" (tol {GRAD_TOL:g})" if syrk == "s4" else " (not gated)"))
            if syrk == "s4" and not g_rel <= GRAD_TOL:
                raise AssertionError(f"the s4 gradient {name} is off the f64 plain path by {g_rel:.3e}")
    launches = read_counts()
    model.zero_grad(set_to_none=True)
    print(f"phase 4k main path's launches by arithmetic: fused {launches['chol_solve']}, factor only "
          f"{launches['cholesky']}")
    if not all(launches["chol_solve"][m] > 0 for m in ("s3", "s4")):
        raise AssertionError(f"the main path did not run the fused kernel in s3 and s4: {launches}")

    def objective(syrk):
        def run():
            with torch.no_grad():
                split_objective(torch, cholesky, model, syrk)
        return run

    def stock():
        with gft.config.temp_settings(use_kernels=False), torch.no_grad():
            model.objective()

    times = {"s4": cuda_ms(torch, objective("s4")), "hi": cuda_ms(torch, objective("hi")), "cuSOLVER": cuda_ms(torch, stock)}
    for k in ("s4", "hi", "cuSOLVER"):
        times[k] += cuda_ms(torch, objective(k) if k != "cuSOLVER" else stock)
    times = {k: statistics.median(v) for k, v in times.items()}
    print(f"split objective at N={N} (median of {2 * REPS}, CUDA events): s4 kernel {times['s4']:.3f} ms, hi kernel "
          f"{times['hi']:.3f} ms, use_kernels=False (cuSOLVER) {times['cuSOLVER']:.3f} ms")
    # fault l's grid: each split mode's half-logdet beside hi's and cuSOLVER's (a finding, not a gate)
    Xg, _, _ = vgp_data()
    K = gram.gram_lower_cuda("rbf", (torch.tensor(Xg, device=dev) / VGP_LS).contiguous(), torch.tensor(1.0, device=dev))
    zero = torch.zeros(len(K), 1, device=dev)
    for jitter in LOGDET_JITTERS:
        Kj = K.clone()
        Kj.diagonal().add_(jitter)
        ref = float(torch.log(torch.diagonal(cholesky.cholesky_plain(torch.tril(Kj).double()))).sum())
        lib = float(torch.log(torch.diagonal(cholesky.cholesky_plain(torch.tril(Kj))).double()).sum())
        errs = {"cuSOLVER": abs(lib - ref) / abs(ref)}
        for syrk in ("hi",) + SPLIT_MODES:
            fused = float(cholesky.cholesky_solve_cuda(Kj.clone(), zero, syrk)[2])
            fac = float(torch.log(torch.diagonal(cholesky.cholesky_cuda(Kj.clone(), syrk)).double()).sum())
            errs[syrk] = (abs(fac - ref) / abs(ref), abs(fused - ref) / abs(ref))
        print(f"half_logdet rel err on the VGP grid's K + {jitter:g} I (Np={len(Kj)}), factor only / fused: "
              + ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v[0]:.2e} / {v[1]:.2e}"
                          for k, v in errs.items()))
    del K, Kj
    return {"launches": launches, "times": times}


def split_times(torch, cholesky, Kp, Dp1, pad_to, launches):
    """Phase 3 and phase 5 for phase 4k: both Cholesky modes in "s3" and
    "s4" at N = pad_to (bench.py's operand), each held to its plain split
    version in f64 at phase 3's gates, then timed against its plain split
    version in f32 and, as the exact function's yardstick, cuSOLVER's (no
    PyTorch call computes the split): rows of the kernels line."""
    rows = {}
    K64 = torch.tril(Kp).double()
    for syrk in ("s3", "s4"):
        _, a_ref, h_ref = cholesky.cholesky_solve_split_plain(K64.clone(), Dp1.double(), syrk)
        _, a_got, h_got = cholesky.cholesky_solve_cuda(Kp.clone(), Dp1, syrk)
        err = float((a_got.double() - a_ref).abs().max())
        a_rel, h_rel = err / float(a_ref.abs().max()), abs(float(h_got) - float(h_ref)) / abs(float(h_ref))
        print(f"chol_solve_logdet[{syrk}] Np={pad_to} vs its plain version in f64: half_logdet rel err {h_rel:.3e} "
              f"(tol {HLD_TOL:g}), alpha rel err {a_rel:.3e} (tol {ALPHA_TOL:g})")
        if not (h_rel <= HLD_TOL and a_rel <= ALPHA_TOL):
            raise AssertionError(f"the fused kernel in {syrk} disagrees with its plain version at Np={pad_to}")
        del a_ref
        L_ref = cholesky.cholesky_split_plain(K64, syrk)
        Lg = torch.tril(cholesky.cholesky_cuda(Kp.clone(), syrk))
        f_err = float((Lg.double() - L_ref).abs().max())
        f_rel = f_err / float(L_ref.abs().max())
        print(f"cholesky[{syrk}] Np={pad_to} vs its plain version in f64: factor rel err {f_rel:.3e} (tol {FACTOR_TOL:g})")
        if not f_rel <= FACTOR_TOL:
            raise AssertionError(f"the factor-only kernel in {syrk} disagrees with its plain version at Np={pad_to}")
        del L_ref, Lg
        fresh = lambda: (Kp.clone(),)  # noqa: E731
        for name, kernel, plain, exact, nbytes, err_n, n in (
                (f"chol_solve_logdet[{syrk}]", lambda K, s=syrk: cholesky.cholesky_solve_cuda(K, Dp1, s),
                 lambda K, s=syrk: cholesky.cholesky_solve_split_plain(K, Dp1, s),
                 lambda K: cholesky.cholesky_solve_plain(K, Dp1), 2 * tri_bytes(pad_to) + 2 * pad_to * 4, err,
                 launches["chol_solve"][syrk]),
                (f"cholesky[{syrk}]", lambda K, s=syrk: cholesky.cholesky_cuda(K, s),
                 lambda K, s=syrk: cholesky.cholesky_split_plain(K, s), torch.linalg.cholesky_ex,
                 2 * tri_bytes(pad_to), f_err, launches["cholesky"][syrk])):
            k_ms, p_ms = paired_ms(torch, kernel, plain, setup=fresh)
            exact_ms = statistics.median(cuda_ms(torch, exact, fresh))
            b_ms, b_by = split_bound(syrk, pad_to, nbytes)
            rows[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None, "exact_library_ms": exact_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_n, "launches": n,
                          **other_ms(torch, kernel, exact, fresh)}
            print(f"  {name}: kernel {k_ms:.4f} ms (device {rows[name]['device_ms']:.4f}), plain split f32 "
                  f"{p_ms:.4f} ms, cuSOLVER (the exact function) {exact_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return rows


def check_csl_vjp(torch, cholesky, chol_inverse, Kp, Dp1):
    """The f64 VJP's kernels (``csl_vjp_cuda``) against their plain
    version on the same inputs at the main path's side: the factor and
    alpha of bench.py's operand ``Kp`` and data ``Dp1``, and the
    objective's cotangents (``ghl`` 1, ``gq`` 1/2). K-bar and D-bar within
    VJP_TOL of the largest entry on top of one f32 rounding, K-bar equal to
    its transpose, its pad block exactly 1/2 ghl I and its pad rows 0
    against the data (beta is 0 there). Returns the inputs and K-bar's max
    abs error."""
    Lp, alpha, _ = cholesky.cholesky_solve_cuda(Kp.clone(), Dp1)
    dev = Lp.device
    args = (Lp, alpha, torch.tensor(1.0, device=dev), torch.tensor(0.5, device=dev))
    Kbar, Dbar = chol_inverse.csl_vjp_cuda(*args)
    Kw, Dw = chol_inverse.csl_vjp_plain(*(t.double() for t in args))
    errs = {}
    for what, got, want in (("Kbar", Kbar, Kw), ("Dbar", Dbar, Dw)):
        over = float(((got.double() - want).abs() - 2.0 ** -24 * want.abs()).max())
        errs[what] = (float((got.double() - want).abs().max()), over / float(want.abs().max()))
    sym = torch.equal(Kbar, Kbar.T)
    pad = torch.equal(Kbar[N:, N:], torch.full((), 0.5, device=dev) * torch.eye(Kbar.shape[0] - N, device=dev))
    pad_rows = bool((Kbar[N:, :N] == 0).all()) and bool((Dbar[N:] == 0).all())
    print(f"csl_vjp kernels vs plain f64 at Np={Kbar.shape[0]}: " + ", ".join(
        f"{w} max abs err {a:.3e}, beyond one f32 rounding {r:.3e} of the largest entry" for w, (a, r) in errs.items())
          + f" (tol {VJP_TOL:g}); Kbar equals Kbar.T: {sym}; pad block exactly 1/2 ghl I: {pad}; "
          f"pad rows 0: {pad_rows}")
    if not (max(r for _, r in errs.values()) <= VJP_TOL and sym and pad and pad_rows):
        raise AssertionError("the f64 VJP's kernels disagree with their plain version")
    del Kbar, Dbar, Kw, Dw
    return args, errs["Kbar"][0]


def opnd_vjp_bound(N):
    """(ms, what bounds it) of the operand's VJP at N: the N x N float32
    cotangent read once, or OPND_VJP_FLOP float64 operations a lower pair
    on the CUDA cores."""
    return max((N * N * 4 / HBM_BYTES * 1e3, "bytes"),
               (N * (N + 1) / 2 * OPND_VJP_FLOP / F64_FLOPS * 1e3, "operations"))


def check_opnd_vjp(torch, gram, Xs, Kbar, pad_to):
    """The operand's VJP kernel (``gram_operand_vjp_cuda``) against its
    plain version on the same inputs at the main path's operand: bench.py's
    scaled inputs and a K-bar of the fused factor's VJP as the cotangent
    (its pad block nonzero), RBF, unit variance. Each leaf within
    OPND_VJP_TOL of its largest entry on top of one f32 rounding, and two
    runs the same bits. Returns the inputs and the largest abs error."""
    var = torch.tensor(1.0, device=Xs.device)
    got = gram.gram_operand_vjp_cuda("rbf", Kbar, Xs, var)
    again = gram.gram_operand_vjp_cuda("rbf", Kbar, Xs, var)
    want = gram.gram_operand_vjp_plain("rbf", Kbar, Xs, var)
    errs = {}
    for what, g, w in zip(("gXs", "gvar", "gnoise"), got, want):
        over = float(((g.double() - w).abs() - 2.0 ** -24 * w.abs()).max())
        errs[what] = (float((g.double() - w).abs().max()), over / float(w.abs().max()))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"operand VJP kernel vs plain f64 at N={Xs.shape[0]}, Np={pad_to}: " + ", ".join(
        f"{w} max abs err {a:.3e}, beyond one f32 rounding {r:.3e} of the largest entry" for w, (a, r) in errs.items())
          + f" (tol {OPND_VJP_TOL:g}); two runs bit for bit: {same}")
    if not (max(r for _, r in errs.values()) <= OPND_VJP_TOL and same):
        raise AssertionError("the operand's VJP kernel disagrees with its plain version")
    return (Kbar, Xs, var), max(a for a, _ in errs.values())


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import gpflow_slim_tpu_torch as gft
    from gpflow_slim_tpu_torch.ops import _build, chol_inverse, cholesky, gram, trsm

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
    serve_errs["gram_lower"] = max(serve_errs["gram_lower"], check_gram_lower_edges(torch, gram, dev))
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
    # the split trailing-update modes against their plain versions
    split_apart = check_split_modes_apart(torch, _build, cholesky, dev)
    split_errs = check_split_kernels(torch, gram, cholesky, np.random.RandomState(15), dev)

    # 4. the training path at full width, through the public entry points
    model = gft.models.GPR(X, Y, kern=gft.kernels.RBF(1, lengthscales=LENGTHSCALE),
                           device="cuda", dtype=torch.float32)
    gram.gram_chol_operand_cuda.launches = 0
    cholesky.cholesky_solve_cuda.launches = 0
    chol_inverse.csl_vjp_cuda.launches = 0
    gram.gram_operand_vjp_cuda.launches = 0
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
    n_vjp = chol_inverse.csl_vjp_cuda.launches
    n_opnd_vjp = gram.gram_operand_vjp_cuda.launches
    model.objective().backward()
    if chol_inverse.csl_vjp_cuda.launches != n_vjp + 1:
        raise AssertionError("the gradient did not run the f64 VJP kernels (csrc/chol_inverse.cu) once")
    if gram.gram_operand_vjp_cuda.launches != n_opnd_vjp + 1:
        raise AssertionError("the gradient did not run the operand's VJP kernel (csrc/gram_operand.cu) once")
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
    n_vjp, n_opnd_vjp = chol_inverse.csl_vjp_cuda.launches, gram.gram_operand_vjp_cuda.launches
    print(f"launches over the main path (objective, gradient, 5 steps): "
          f"operand {n_opnd}, chol_solve {n_chol}, csl_vjp {n_vjp}, gram_operand_vjp {n_opnd_vjp}")
    Dp1 = torch.zeros(pad_to, 1, dtype=torch.float32, device=dev)
    Dp1[:N] = torch.tensor(Y, device=dev)
    vjp_args, vjp_err = check_csl_vjp(torch, cholesky, chol_inverse, Kp, Dp1)
    opnd_vjp_args, opnd_vjp_err = check_opnd_vjp(torch, gram, Xs, chol_inverse.csl_vjp_cuda(*vjp_args)[0], pad_to)

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

    # 4f. config #4 (NUTS over the GPR hyperparameters, 8 chains) at full
    # width, then GPMC and SGPMC
    nuts_launches = mcmc_checks(gft, torch, gram, cholesky, dev)
    n_gpmc, mc_launches = mc_checks(gft, torch, gram, cholesky, trsm, dev)

    # 4g. the full-data variational slice (VGP, VGPOpperArchambeau,
    # fit_lbfgs on entry()'s GPR) at full width: its kernels at its shapes,
    # the models against the f64 plain path, the launch check
    vgp_errs, vgp_L, stock_finite = check_vgp_kernels(gft, torch, gram, cholesky, trsm, dev)
    vgp_launches, vgp_models = vgp_checks(gft, torch, gram, cholesky, trsm, stock_finite, dev)
    vgp_errs["cholesky"] = max(vgp_errs["cholesky"], oa_logdet_check(gft, torch, cholesky, vgp_models["OA"]))
    vgp_launch_check(gft, torch, vgp_models)

    # 4h. the matrix-free and latent-variable slice: config #5 on one chip
    # (GPRCG streaming, deep kernel, N=50000), GPRCG against the exact GPR,
    # GPLVM and BayesianGPLVM with uncertain_conditional, the NKN GPR
    cg_out, cg_model = cg_checks(gft, torch, gram, cholesky, trsm, dev, card)
    exact_vs_cg(gft, torch, dev)
    lvm_launches, lvm_models = lvm_checks(gft, torch, gram, cholesky, trsm, dev)
    nkn_launches = nkn_checks(gft, torch, gram, cholesky, trsm, dev)
    nkn_rows = nkn_operand_checks(gft, torch, dev)
    # fault m on the card: batched_value_and_grad over config #5's streaming model
    cg_func_check(gft, torch, gram, cholesky, trsm, cg_model, dev)

    # 4i. config #3 trained from disk through the data-parallel step on a
    # 1-rank nccl world, checkpointed and resumed; bench.py's GPR served
    # from a checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        dp_out = dp_checks(gft, torch, gram, cholesky, trsm, dev, card, tmp)
        serve_out = serve_ckpt_checks(gft, torch, gram, cholesky, trsm, dev, card, dp_out["deterministic"], tmp)

    # 4j. the distributed exact-GP paths on a 1-rank nccl world: config #5
    # (N=50000) through the distributed block-Cholesky, then bench.py's GPR
    # through the identity of the distributed loss, the cyclic and grid
    # factors, the grid loss, the distributed CG and the ring matvec;
    # config #4's chains over the mesh; the dry run
    gft.parallel.initialize_distributed(f"localhost:{free_port()}", 1, 0)  # nccl on the card
    try:
        mesh = gft.parallel.make_mesh({"rows": 1})
        dist_out = dist_config5(gft, torch, gram, cholesky, trsm, mesh, dev, card)
        dist_paths(gft, torch, gram, cholesky, trsm, mesh, dev, card)
    finally:
        torch.distributed.destroy_process_group()

    # 4k. the Cholesky kernels' split-bf16 trailing-update modes through the
    # public entry points, held to the JAX package's own hardware gates, and
    # the main path (bench.py's GPR objective and gradient) in "s4"
    split_out = split_checks(gft, torch, gram, cholesky, model, grads64, dev)

    # 5. times on the card, kernel route against plain
    def on_card(ms):
        return f"{ms:.3f} ms"

    opnd = lambda: gram.gram_chol_operand_cuda("rbf", Xs, var, noise, pad_to)  # noqa: E731
    opnd_ms, opnd_plain_ms = paired_ms(
        torch, opnd, lambda: gram.gram_chol_operand_plain("rbf", Xs, var, noise, pad_to))
    chol = lambda K: cholesky.cholesky_solve_cuda(K, Dp1)  # noqa: E731
    chol_ms, chol_plain_ms = paired_ms(
        torch, chol, lambda K: cholesky.cholesky_solve_plain(K, Dp1), setup=lambda: (Kp.clone(),))
    vjp = lambda: chol_inverse.csl_vjp_cuda(*vjp_args)  # noqa: E731
    vjp_ms, vjp_plain_ms = paired_ms(torch, vjp, lambda: chol_inverse.csl_vjp_plain(*vjp_args))
    L64, eye64 = torch.tril(vjp_args[0]).double(), torch.eye(pad_to, dtype=torch.float64, device=dev)

    def vjp_library():  # the cuBLAS pair the kernels replace: the solve against I, the full product
        Linv = torch.linalg.solve_triangular(L64, eye64, upper=False)
        return Linv.T @ Linv

    vjp_lib_ms = statistics.median(cuda_ms(torch, vjp_library))
    opnd_vjp = lambda: gram.gram_operand_vjp_cuda("rbf", *opnd_vjp_args)  # noqa: E731
    opnd_vjp_ms, opnd_vjp_plain_ms = paired_ms(torch, opnd_vjp,
                                               lambda: gram.gram_operand_vjp_plain("rbf", *opnd_vjp_args))
    other = {"gram_chol_operand": other_ms(torch, opnd),
             "chol_solve_logdet": other_ms(torch, chol, setup=lambda: (Kp.clone(),)),
             "csl_vjp": other_ms(torch, vjp, vjp_library),
             "gram_operand_vjp": other_ms(torch, opnd_vjp)}
    del L64, eye64

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
    print(f"  csl_vjp (f64): kernels {on_card(vjp_ms)} (device {other['csl_vjp']['device_ms']:.4f}), plain f64 "
          f"{on_card(vjp_plain_ms)}, cuBLAS solve against I + full product {on_card(vjp_lib_ms)}")
    print(f"  gram_operand_vjp (f64): kernel {on_card(opnd_vjp_ms)} (device "
          f"{other['gram_operand_vjp']['device_ms']:.4f}), plain f64 {on_card(opnd_vjp_plain_ms)}, "
          f"bound {opnd_vjp_bound(N)[0]:.4f} ms")
    print(f"  objective: kernels {on_card(obj_ms)}, use_kernels=False {on_card(obj_plain_ms)}")
    print(f"  objective+grad: kernels {on_card(og_ms)}, use_kernels=False {on_card(og_plain_ms)}; "
          f"peak memory {peak_gb:.2f} GB (the backwards differ: float64 _csl_bwd on the "
          f"kernel route, float32 autograd through cuSOLVER on the other)")

    # the serving path's kernels, at the shapes of its requests
    gram_k = lambda: gram.gram_cuda("rbf", Xs, Xqs, var)  # noqa: E731
    gram_ms, gram_plain_ms = paired_ms(torch, gram_k, lambda: gram.gram_reference("rbf", Xs, Xqs, var))
    Xqr = Xqs[:NQ - 1].contiguous()  # a ragged M: the scalar-store variant
    ragged_ms, ragged_plain_ms = paired_ms(torch, lambda: gram.gram_cuda("rbf", Xs, Xqr, var),
                                           lambda: gram.gram_reference("rbf", Xs, Xqr, var))
    ragged = {"ms": ragged_ms, "plain_ms": ragged_plain_ms,
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
          f"{ragged['device_ms']:.4f}), plain f32 {ragged['plain_ms']:.4f} ms")
    print(f"  lower-tile gram ({N}): kernel {on_card(glow_ms)} (runs of {RUN} {other['gram_lower']['run20_ms']:.4f}, "
          f"device {other['gram_lower']['device_ms']:.4f}; host {(glow_ms - other['gram_lower']['device_ms']) * 1e3:.2f} "
          f"us a call), plain f32 {on_card(glow_plain_ms)}")
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
    # config #4, and GPMC's lower-tile Gram
    nuts_rows = nuts_times(torch, gram, cholesky, dev)
    gpmc_row = gpmc_lower_times(torch, gram, n_gpmc, dev)
    # the full-data variational slice
    vgp_rows = vgp_times(gft, torch, gram, cholesky, trsm, vgp_L, vgp_models, dev, card)
    # the matrix-free and latent-variable slice
    slice_rows = slice_times(gft, torch, gram, trsm, cg_model, lvm_models["BayesianGPLVM"], dev)
    # phase 4i's data-parallel step and restored posterior
    rows4i = slice4i_times(gft, torch, gram, cholesky, trsm, dp_out, serve_out, dev)
    # phase 4j's distributed path
    rows4j = slice4j_times(gft, torch, gram, cholesky, trsm, dist_out["model"], dev)
    # phase 4k's split modes
    split_rows = split_times(torch, cholesky, Kp, Dp1, pad_to, split_out["launches"])
    print(f"split rows' phase 3 max abs errs at the test sides: {split_errs}; one trailing update against its "
          f"own arithmetic: rel err {split_apart:.3e}")

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
        # f64 on the tensor cores: the inverse's Np^3 / 3 and the lower half of W^T W's Np^3 / 3
        "csl_vjp": (2 * pad_to ** 3 / 3 / F64_TC_FLOPS * 1e3, "operations"),
        "gram_operand_vjp": opnd_vjp_bound(N),
    }
    print(card)

    def row(name, source, replaces, launches, err, ms, plain_ms, library_ms):
        b_ms, b_by = bounds[name]
        return {"name": name, "route": "cuda", "source": f"gpflow_slim_tpu_torch/csrc/{source}",
                "replaces": f"gpflow_slim_tpu/ops/{replaces}", "launches": launches, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                **other[name], "host_us": host_us(ms, other[name]["device_ms"])}

    def timed_row(name, source, replaces, launches, err, timed):
        bounds[name] = (timed["bound_ms"], timed["bound_by"])
        other[name] = {k: timed[k] for k in ("run20_ms", "device_ms", "library_run20_ms", "library_device_ms")}
        return row(name, source, replaces, launches, err, timed["ms"], timed["plain_ms"], timed["library_ms"])

    by_shape = svgp_launches["gram_by_shape"]
    dp_by_shape = dp_out["launches"]["gram_by_shape"]
    print(json.dumps({"kernels": [
        row("gram_chol_operand", "gram_operand.cu", "pallas_gram.py:328", n_opnd, operand_err, opnd_ms,
            opnd_plain_ms, None),
        row("chol_solve_logdet", "chol_solve.cu", "pallas_cholesky.py:857", n_chol, chol_err, chol_ms,
            chol_plain_ms, None),
        # replaces no TPU kernel: its counterpart, _csl_bwd, is XLA ops
        row("csl_vjp", "chol_inverse.cu", "pallas_cholesky.py:913", n_vjp, vjp_err, vjp_ms, vjp_plain_ms,
            vjp_lib_ms),
        # replaces no TPU kernel: its counterpart, _opnd_bwd, is XLA ops
        row("gram_operand_vjp", "gram_operand.cu", "pallas_gram.py:363", n_opnd_vjp, opnd_vjp_err, opnd_vjp_ms,
            opnd_vjp_plain_ms, None),
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
        timed_row("gram_chol_operand_nuts", "gram_operand.cu", "pallas_gram.py:328", nuts_launches["operand"],
                 nuts_rows["gram_chol_operand_nuts"]["max_abs_err"], nuts_rows["gram_chol_operand_nuts"]),
        timed_row("chol_solve_logdet_nuts", "chol_solve.cu", "pallas_cholesky.py:857", nuts_launches["chol_solve"],
                 nuts_rows["chol_solve_logdet_nuts"]["max_abs_err"], nuts_rows["chol_solve_logdet_nuts"]),
        timed_row("gram_lower_vgp", "gram.cu", "pallas_gram.py:173", vgp_launches["VGP"]["gram_lower"],
                 vgp_errs["gram_lower"], vgp_rows["gram_lower_vgp"]),
        timed_row("gram_lower_gpmc", "gram.cu", "pallas_gram.py:173", mc_launches["GPMC"]["gram_lower"],
                 gpmc_row["max_abs_err"], gpmc_row),
        timed_row("cholesky_vgp", "chol_solve.cu", "pallas_cholesky.py:716",
                 vgp_launches["VGP"]["cholesky"] + vgp_launches["OA"]["cholesky"], vgp_errs["cholesky"],
                 vgp_rows["cholesky_vgp"]),
        timed_row("trsm_vgp", "trsm.cu", "pallas_trsm.py:116",
                 vgp_launches["VGP"]["trsm_wide"] + vgp_launches["OA"]["trsm_wide"], vgp_errs["trsm"],
                 vgp_rows["trsm_vgp"]),
        *(timed_row(name, "gram.cu", "pallas_gram.py:95",
                    sum(vgp_launches[w]["gram_by_shape"].get((n, cols or n), 0) for w, n in (("VGP", VGP_N),
                                                                                         ("OA", OA_N))),
                    vgp_errs["gram"], vgp_rows[name])
          for name, cols in (("gram_vgp_kxx", None), ("gram_vgp_kxq", VGP_NQ))),
        timed_row("gram_chol_operand_entry", "gram_operand.cu", "pallas_gram.py:328", vgp_launches["lbfgs"]["operand"],
                 vgp_errs["operand"], vgp_rows["gram_chol_operand_entry"]),
        timed_row("chol_solve_logdet_entry", "chol_solve.cu", "pallas_cholesky.py:857",
                 vgp_launches["lbfgs"]["chol_solve"], vgp_errs["chol_solve"], vgp_rows["chol_solve_logdet_entry"]),
        timed_row("gram_cg_panel", "gram.cu", "pallas_gram.py:95",
                 cg_out["config5"]["launches"]["gram_by_shape"].get((gft.models.cg_gpr.STREAM_BLOCK, CG_N), 0),
                 slice_rows["gram_cg_panel"]["max_abs_err"], slice_rows["gram_cg_panel"]),
        timed_row("trsm_bgplvm", "trsm.cu", "pallas_trsm.py:116", lvm_launches["BayesianGPLVM"]["trsm_wide"],
                 slice_rows["trsm_bgplvm"]["max_abs_err"], slice_rows["trsm_bgplvm"]),
        *(timed_row(name, source, replaces, launches, rows4i[name]["max_abs_err"], rows4i[name])
          for name, source, replaces, launches in (
              ("gram_dp_kuu", "gram.cu", "pallas_gram.py:95", dp_by_shape.get((SVGP_M, SVGP_M), 0)),
              ("gram_dp_kuf", "gram.cu", "pallas_gram.py:95", dp_by_shape.get((SVGP_M, SVGP_B), 0)),
              ("cholesky_dp", "chol_solve.cu", "pallas_cholesky.py:716", dp_out["launches"]["cholesky"]),
              ("trsm_dp", "trsm.cu", "pallas_trsm.py:116", dp_out["launches"]["trsm_wide"]),
              ("gram_serve_ckpt", "gram.cu", "pallas_gram.py:95", serve_out["launches"]["gram"]),
              ("trsm_serve_ckpt", "trsm.cu", "pallas_trsm.py:116", serve_out["launches"]["trsm_wide"]))),
        *(timed_row(name, source, replaces, launches, rows4j[name]["max_abs_err"], rows4j[name])
          for name, source, replaces, launches in (
              ("gram_dist_panel", "gram.cu", "pallas_gram.py:95",
               dist_out["launches"]["gram_by_shape"].get((DIST_PANEL, DIST_N), 0)),
              ("cholesky_dist", "chol_solve.cu", "pallas_cholesky.py:716", dist_out["launches"]["cholesky"]),
              ("trsm_dist", "trsm.cu", "pallas_trsm.py:116", dist_out["launches"]["trsm_wide"]))),
        # no TPU kernel: the JAX package forms an NKN's Gram from its primitives' Grams with XLA ops
        *({**timed_row(name, "nkn_operand.cu", "pallas_gram.py", r["launches"], r["max_abs_err"], r),
           "replaces": "gpflow_slim_tpu/kernels_nkn.py:88 (XLA ops, no TPU kernel)"} for name, r in nkn_rows.items()),
        # library_ms null: no PyTorch call computes the split; exact_library_ms is cuSOLVER's exact function
        *({"name": name, "route": "cuda", "source": "gpflow_slim_tpu_torch/csrc/chol_solve.cu",
           "replaces": "gpflow_slim_tpu/ops/pallas_cholesky.py:" + ("857" if name.startswith("chol_solve") else "716"),
           **r, "host_us": host_us(r["ms"], r["device_ms"])} for name, r in split_rows.items()),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
