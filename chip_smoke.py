#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpflow_slim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two exact-GPR paths at bench.py's size (N=10000, D=1,
RBF with lengthscale 0.1, float32) through its public entry points, and
checks them: the marginal-likelihood (training) path and the serving path
(posterior and predictions).

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: the hand-written kernels with nvcc for sm_90a from csrc/ (one
   nvcc per source, in parallel);
3. each kernel against its plain PyTorch version, run in float64 on the
   card on the same inputs: the Gram operand and the fused
   factor/solve/logdet of the training path; the cross Gram (10000 x 2048,
   six kinds and D=3), the lower-tile Gram, the factor-only Cholesky and
   the TRSM (lower, and upper through the transposed view; P = 1, 7, 2048)
   of the serving path;
4. the training path: GPR.objective() (both of its kernels must launch),
   against an f64 oracle at the effective hyperparameters (gate 1e-5
   relative, as bench.py); the gradient against the f64 plain path (1e-3
   relative); 5 Adam steps of training.fit must lower the loss;
4b. the serving path: GPR.posterior(), four predict_f requests of 2048
   points, one full-covariance request of 1024, predict_y and
   predict_density, and one uncached GPR.predict_f (its four kernels must
   launch); means and variances against an f64 oracle, gated relative to
   the use_kernels=False float32 route;
5. times (CUDA events, median) of each kernel against its plain version
   and of each path's entry points, kernel route against the
   use_kernels=False route, with peak memory.

Any failure raises and exits non-zero. Without a CUDA device, or without
the package beside this file, it exits non-zero and prints no result. The
last line is {"ok": true, "device": {...}}.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

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


def cuda_ms(torch, fn, setup=lambda: (), reps=REPS, warmup=2):
    """Median milliseconds of fn(*setup()) by CUDA events; setup is untimed."""
    times = []
    for i in range(warmup + reps):
        args = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return times


def paired_ms(torch, kernel_fn, plain_fn, setup=lambda: ()):
    """Plain, kernel, kernel, plain; the median of each side's samples."""
    plain = cuda_ms(torch, plain_fn, setup)
    kern = cuda_ms(torch, kernel_fn, setup)
    kern += cuda_ms(torch, kernel_fn, setup)
    plain += cuda_ms(torch, plain_fn, setup)
    return statistics.median(kern), statistics.median(plain)


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
    for P in (1, 7, NQ):
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
        raise RuntimeError("TF32 matmul is on; the port's f32 paths need full precision")

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
    for n, p in gft.params.parameters(m64):
        g64 = float(p.unconstrained.grad)
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
    post, answers = serving_requests(gft, torch, serve)
    torch.cuda.synchronize()
    serve_launches = {name: fn.launches for name, fn in serve_kernels.items()}
    print(f"serving path (posterior, 4 x predict_f at {NQ}, full_cov at {NQ_FULL}, predict_y, "
          f"predict_density, uncached predict_f): launches {serve_launches}")
    if not all(n > 0 for n in serve_launches.values()):
        raise AssertionError(f"the serving path did not run all four of its kernels: {serve_launches}")
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
            e_k = float((k_t.double() - o_t).abs().max())
            e_p = float((p_t.double() - o_t).abs().max())
            gate = 2 * e_p + SERVE_ABS
            print(f"serving {key} {what} vs f64 oracle: kernel route {e_k:.3e}, use_kernels=False "
                  f"f32 route {e_p:.3e} (gate 2 x that + {SERVE_ABS:g} = {gate:.3e})")
            if not e_k <= gate:
                raise AssertionError(f"serving {key} {what}: kernel route {e_k:.3e} > gate {gate:.3e}")
    del plain_answers, oracles

    # 5. times on the card, kernel route against plain
    def on_card(ms):
        return f"{ms:.3f} ms"

    Dp1 = torch.zeros(pad_to, 1, dtype=torch.float32, device=dev)
    Dp1[:N] = torch.tensor(Y, device=dev)
    opnd_ms, opnd_plain_ms = paired_ms(
        torch,
        lambda: gram.gram_chol_operand_cuda("rbf", Xs, var, noise, pad_to),
        lambda: gram.gram_chol_operand_plain("rbf", Xs, var, noise, pad_to))
    chol_ms, chol_plain_ms = paired_ms(
        torch,
        lambda K: cholesky.cholesky_solve_cuda(K, Dp1),
        lambda K: cholesky.cholesky_solve_plain(K, Dp1),
        setup=lambda: (Kp.clone(),))

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
    gram_ms, gram_plain_ms = paired_ms(
        torch, lambda: gram.gram_cuda("rbf", Xs, Xqs, var),
        lambda: gram.gram_reference("rbf", Xs, Xqs, var))
    glow_ms, glow_plain_ms = paired_ms(
        torch, lambda: gram.gram_lower_cuda("rbf", Xs, var),
        lambda: gram.gram_lower_plain("rbf", Xs, var))
    fac_ms, fac_plain_ms = paired_ms(
        torch, cholesky.cholesky_cuda, cholesky.cholesky_plain, setup=lambda: (Kp.clone(),))
    Bq = torch.tensor(rng.randn(N, NQ), dtype=torch.float32, device=dev)
    trsm_ms, trsm_plain_ms = paired_ms(
        torch, lambda: trsm.trsm_cuda(L, Bq, True),
        lambda: trsm.solve_triangular_plain(L, Bq, True))
    B1 = Bq[:, :1].contiguous()
    trsm1_ms, trsm1_plain_ms = paired_ms(
        torch, lambda: trsm.trsm_cuda(L.T, B1, False),
        lambda: trsm.solve_triangular_plain(L.T, B1, False))

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
    print(f"  cross gram ({N} x {NQ}): kernel {on_card(gram_ms)}, plain f32 {on_card(gram_plain_ms)}")
    print(f"  lower-tile gram ({N}): kernel {on_card(glow_ms)}, plain f32 {on_card(glow_plain_ms)}")
    print(f"  cholesky factor only ({pad_to}): kernel {on_card(fac_ms)}, plain f32 (cuSOLVER) "
          f"{on_card(fac_plain_ms)}")
    print(f"  trsm lower P={NQ}: kernel {on_card(trsm_ms)}, plain f32 (cuBLAS) {on_card(trsm_plain_ms)}; "
          f"upper through L.T, P=1: kernel {on_card(trsm1_ms)}, plain f32 {on_card(trsm1_plain_ms)}")
    print(f"  posterior(): kernels {on_card(post_ms)}, use_kernels=False {on_card(post_plain_ms)}; "
          f"peak memory above the model {peaks[True]:.2f} GB and {peaks[False]:.2f} GB")
    print(f"  predict_f request, N*={NQ}: kernels {on_card(req_ms)}, use_kernels=False "
          f"{on_card(req_plain_ms)}")
    print(f"  predict_f full_cov request, N*={NQ_FULL}: kernels {on_card(full_ms)}, use_kernels=False "
          f"{on_card(full_plain_ms)}")

    print(card)
    print(json.dumps({"kernels": [
        {"name": "gram_chol_operand", "route": "cuda",
         "source": "gpflow_slim_tpu_torch/csrc/gram_operand.cu",
         "replaces": "gpflow_slim_tpu/ops/pallas_gram.py:328",
         "launches": n_opnd, "max_abs_err": operand_err, "ms": opnd_ms, "plain_ms": opnd_plain_ms},
        {"name": "chol_solve_logdet", "route": "cuda",
         "source": "gpflow_slim_tpu_torch/csrc/chol_solve.cu",
         "replaces": "gpflow_slim_tpu/ops/pallas_cholesky.py:857",
         "launches": n_chol, "max_abs_err": chol_err, "ms": chol_ms, "plain_ms": chol_plain_ms},
        {"name": "gram", "route": "cuda",
         "source": "gpflow_slim_tpu_torch/csrc/gram.cu",
         "replaces": "gpflow_slim_tpu/ops/pallas_gram.py:95",
         "launches": serve_launches["gram"], "max_abs_err": serve_errs["gram"],
         "ms": gram_ms, "plain_ms": gram_plain_ms},
        {"name": "gram_lower", "route": "cuda",
         "source": "gpflow_slim_tpu_torch/csrc/gram.cu",
         "replaces": "gpflow_slim_tpu/ops/pallas_gram.py:173",
         "launches": serve_launches["gram_lower"], "max_abs_err": serve_errs["gram_lower"],
         "ms": glow_ms, "plain_ms": glow_plain_ms},
        {"name": "cholesky", "route": "cuda",
         "source": "gpflow_slim_tpu_torch/csrc/chol_solve.cu",
         "replaces": "gpflow_slim_tpu/ops/pallas_cholesky.py:716",
         "launches": serve_launches["cholesky"], "max_abs_err": serve_errs["cholesky"],
         "ms": fac_ms, "plain_ms": fac_plain_ms},
        {"name": "trsm", "route": "cuda",
         "source": "gpflow_slim_tpu_torch/csrc/trsm.cu",
         "replaces": "gpflow_slim_tpu/ops/pallas_trsm.py:116",
         "launches": serve_launches["trsm"], "max_abs_err": serve_errs["trsm"],
         "ms": trsm_ms, "plain_ms": trsm_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
