#!/usr/bin/env python3
"""The Cholesky kernel's half-logdet on an ill-conditioned K, against
cuSOLVER's, on one NVIDIA GPU.

    python3 tools/chol_logdet_diag.py

On the lower-tile Gram of chip_smoke.py phase 4g's 64 x 32 grid (N=2048,
RBF lengthscale 0.1, float32) plus a jitter of 1e-4, 1e-3 and 1e-2, it
factors K with the factor-only kernel, the fused kernel and cuSOLVER
(float32) and prints, against the float64 factor of the same float32
input: each one's half-logdet and its relative error; the error of the
log pivots summed over each 256-wide panel (its sign says whether it is a
bias); and each factor's backward error E = L L^T - K (largest entry, on
the diagonal, and tr(K^-1 E) / 2, the first-order logdet error it
carries). Then, for the split trailing-update modes ("s3", "s4", "s3d",
"s4d"), the half-logdet's relative error of both kernel modes beside "hi"'s
and cuSOLVER's (tools/split_diag.py runs this on variants of the kernel
that sum the split's products otherwise).

The card's name and power limit come first. Needs a CUDA device.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gpflow_slim_tpu_torch.ops import cholesky, gram  # noqa: E402

PANEL = 256


def main():
    if not torch.cuda.is_available():
        print("chol_logdet_diag: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(cs.card_line())
    dev = torch.device("cuda")
    X, _, _ = cs.vgp_data()
    xs = (torch.tensor(X, device=dev) / cs.VGP_LS).contiguous()
    K = gram.gram_lower_cuda("rbf", xs, torch.tensor(1.0, device=dev))
    for jitter in (1e-4, 1e-3, 1e-2):
        Kj = K.clone()
        Kj.diagonal().add_(jitter)
        K64 = torch.tril(Kj).double()
        L64 = cholesky.cholesky_plain(K64)
        d64 = torch.log(torch.diagonal(L64))
        ref = float(d64.sum())
        L_k = torch.tril(cholesky.cholesky_cuda(Kj.clone()))
        L_l = cholesky.cholesky_plain(torch.tril(Kj))
        _, _, h_fused = cholesky.cholesky_solve_cuda(Kj.clone(), torch.zeros(len(Kj), 1, device=dev))
        e_k = torch.log(torch.diagonal(L_k).double()) - d64
        e_l = torch.log(torch.diagonal(L_l).double()) - d64
        print(f"jitter {jitter:g}: half_logdet f64 {ref:.4f}; factor-only kernel {ref + float(e_k.sum()):.4f} "
              f"(rel {abs(float(e_k.sum())) / abs(ref):.2e}), fused kernel {float(h_fused):.4f} "
              f"(rel {abs(float(h_fused) - ref) / abs(ref):.2e}), cuSOLVER {ref + float(e_l.sum()):.4f} "
              f"(rel {abs(float(e_l.sum())) / abs(ref):.2e})")
        for q in range(0, len(Kj), PANEL):
            sl = slice(q, q + PANEL)
            print(f"  log pivots {q}-{q + PANEL - 1}: summed error kernel {float(e_k[sl].sum()):+.4e}, cuSOLVER "
                  f"{float(e_l[sl].sum()):+.4e}")
        Kfull = K64 + K64.tril(-1).T
        for name, L in (("kernel", L_k.double()), ("cuSOLVER", L_l.double())):
            E = L @ L.T - Kfull
            print(f"  {name}: backward error max |L L^T - K| {float(E.abs().max()):.3e}, on the diagonal "
                  f"{float(E.diagonal().abs().max()):.3e}, tr(K^-1 E) / 2 "
                  f"{0.5 * float(torch.trace(torch.cholesky_solve(E, L64))):+.4e}")
        zero = torch.zeros(len(Kj), 1, device=dev)
        for syrk in ("s3", "s4", "s3d", "s4d"):
            L_s = torch.diagonal(cholesky.cholesky_cuda(Kj.clone(), syrk)).double()
            h_s = float(cholesky.cholesky_solve_cuda(Kj.clone(), zero, syrk)[2])
            print(f"  syrk={syrk}: half_logdet rel err factor-only / fused "
                  f"{abs(float(torch.log(L_s).sum()) - ref) / abs(ref):.2e} / {abs(h_s - ref) / abs(ref):.2e} "
                  f"(hi {abs(float(e_k.sum())) / abs(ref):.2e} / {abs(float(h_fused) - ref) / abs(ref):.2e}, "
                  f"cuSOLVER {abs(float(e_l.sum())) / abs(ref):.2e})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
