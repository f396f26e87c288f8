#!/usr/bin/env python3
"""The Cholesky kernel's arithmetic (csrc/chol_solve.cu) emulated on the CPU,
to see which order of its float32 updates biases the half-logdet.

    python3 tools/chol_order_emulate.py [grid|bench] [JITTER] [MODE ...]

It factors, in numpy, the matrix phase 4g of chip_smoke.py factors (the
lower-tile Gram of the 64 x 32 grid, RBF lengthscale 0.1, float32, plus
JITTER I; ``grid``) or bench.py's GPR operand (N=10000 padded to 10048,
noise 1; ``bench``, slow: a few minutes), the way the kernel does: the
pivots (the diagonal of each Schur complement) in float64, each 64 x 64
diagonal block factored in float64 and stored in float32, the panel solve
in float32 with reciprocal pivots, the updates inside a 256-wide panel as
float32 sums of 64 products from zero. A float32 FMA is emulated exactly:
the product of two float32 values is exact in float64, and the sum is
rounded to float32 once. The trailing update after each panel is one of:

  fma     from the entry, one FMA at a time (the kernel's first design)
  sum64   float32 sums of each 64 products from zero, added to the entry
          one after another (the kernel's present design)
  sum256  the float32 sum of the panel's 256 products, added once
  band64  fma, but the 64 x 64 diagonal blocks' entries kept in float64

It prints each mode's half-logdet and its error against the float64 factor
of the same float32 input. Defaults: grid 1e-4 fma sum64 sum256 band64.
"""

import sys
import time

import numpy as np

BS, PW = 64, 256  # the kernel's block and panel widths


def f32(a):
    return a.astype(np.float32).astype(np.float64)


def grid_K(jitter):
    gx, gy = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 32), indexing="ij")
    X = f32(np.stack([gx.ravel(), gy.ravel()], 1)) / 0.1
    K = np.exp(-0.5 * ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)).astype(np.float32)
    K[np.diag_indices_from(K)] += np.float32(jitter)
    return K


def bench_K(N=10000, Np=10048):
    X = f32(np.random.RandomState(0).uniform(0, 1, (N, 1))) / 0.1
    K = np.eye(Np, dtype=np.float32)
    K[:N, :N] = np.exp(-0.5 * (X - X.T) ** 2).astype(np.float32)
    K[np.arange(N), np.arange(N)] += np.float32(1.0)
    return K


def sgemm(A, B):
    """A B^T summed in float32 from zero (numpy's float32 product)."""
    return (A.astype(np.float32) @ B.astype(np.float32).T).astype(np.float64)


def factor(K, mode):
    N = K.shape[0]
    A = K.astype(np.float64)
    dpiv = np.diag(K).astype(np.float64).copy()
    band = mode == "band64"
    for p0 in range(0, N, PW):
        pe = min(p0 + PW, N)
        pend = []  # this panel's L columns, rows from pe on
        for b0 in range(p0, pe, BS):
            s = slice(b0, b0 + BS)
            Abb = np.tril(A[s, s], -1)
            Lbb = f32(np.linalg.cholesky(Abb + Abb.T + np.diag(dpiv[s])))
            A[s, s] = Lbb
            r0 = b0 + BS
            if r0 >= N:
                break
            v = A[r0:, s].copy()  # the panel solve, row by row, reciprocal pivots
            dinv = f32(1.0 / Lbb.diagonal())
            for j in range(BS):
                v[:, j] = f32(v[:, j] * dinv[j])
                if j + 1 < BS:
                    v[:, j + 1:] = f32(v[:, j + 1:] - v[:, j:j + 1] * Lbb[j + 1:, j][None, :])
            A[r0:, s] = v
            dpiv[r0:] -= (v ** 2).sum(1)
            if pe > r0:  # the panel's later columns: a sum of 64 from zero
                A[r0:, r0:pe] = f32(A[r0:, r0:pe] - sgemm(v, v[:pe - r0]))
            pend.append(v[max(0, pe - r0):])
        if pe >= N:
            break
        T = A[pe:, pe:]
        if mode in ("fma", "band64"):
            blk = np.arange(N - pe) // BS
            near = blk[:, None] == blk[None, :] if band else None
            for v in pend:
                for t in range(BS):
                    exact = T - np.outer(v[:, t], v[:, t])
                    T = np.where(near, exact, f32(exact)) if band else f32(exact)
        elif mode == "sum64":
            for v in pend:
                T = f32(T - sgemm(v, v))
        elif mode == "sum256":
            V = np.concatenate(pend, 1)
            T = f32(T - sgemm(V, V))
        else:
            raise ValueError(f"unknown mode {mode!r}")
        A[pe:, pe:] = T
    return np.tril(A)


def main():
    args = sys.argv[1:]
    which = args[0] if args else "grid"
    jitter = float(args[1]) if len(args) > 1 else 1e-4
    modes = args[2:] or ["fma", "sum64", "sum256", "band64"]
    K = bench_K() if which == "bench" else grid_K(jitter)
    ref = float(np.log(np.diag(np.linalg.cholesky(K.astype(np.float64)))).sum())
    print(f"{which}" + (f", K + {jitter:g} I" if which == "grid" else "") + f" (Np={len(K)}): f64 half_logdet "
          f"{ref:.6f}", flush=True)
    for mode in modes:
        t = time.time()
        h = float(np.log(np.diag(factor(K, mode))).sum())
        print(f"  {mode}: half_logdet {h:.6f}, err {h - ref:+.4e}, rel {abs(h - ref) / abs(ref):.3e} "
              f"[{time.time() - t:.0f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
