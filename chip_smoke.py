#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpflow_slim_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the exact-GPR marginal-likelihood path at bench.py's size (N=10000,
D=1, RBF with lengthscale 0.1, float32) through the port's public entry
points, and checks it:

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: both hand-written kernels with nvcc for sm_90a from csrc/;
3. each kernel against its plain PyTorch version, run in float64 on the
   card on the same inputs;
4. the slice: GPR.objective() (both kernels must launch), against an f64
   oracle at the effective hyperparameters (gate 1e-5 relative, as
   bench.py); the gradient against the f64 plain path (1e-3 relative);
   5 Adam steps of training.fit must lower the loss;
5. times (CUDA events, median) of each kernel and of the objective and
   objective+gradient, kernel route against the use_kernels=False route.

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import gpflow_slim_tpu_torch as gft
    from gpflow_slim_tpu_torch.ops import _build, cholesky, gram

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

    # 4. the slice at full width, through the public entry points
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
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
